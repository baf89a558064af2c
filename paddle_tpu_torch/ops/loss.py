"""Loss ops (the slice's subset of ``paddle_tpu/ops/loss.py``)."""

import torch


def softmax_with_cross_entropy(logits, label, ignore_index=-100):
    """Hard-label softmax cross entropy in the stable logsumexp form (ref:
    ``ops/loss.py:42``). ``label`` holds class ids with a trailing 1
    (``[..., 1]``) or without; rows whose label is ``ignore_index`` give
    0. Returns ``[..., 1]``. The soft-label form and other axes are not
    ported."""
    if label.ndim > 1 and label.shape[-1] == 1:
        label = label.squeeze(-1)
    logz = torch.logsumexp(logits, dim=-1)
    picked = torch.gather(logits, -1,
                          torch.clamp(label.long(), min=0)[..., None])[..., 0]
    loss = torch.where(label == ignore_index, torch.zeros_like(logz),
                       logz - picked)
    return loss[..., None]
