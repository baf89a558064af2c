"""Loss ops (the slice's subset of ``paddle_tpu/ops/loss.py``)."""

import torch


def softmax_with_cross_entropy(logits, label, soft_label=False,
                               ignore_index=-100):
    """Softmax cross entropy over the last axis in the stable logsumexp
    form (ref: ``ops/loss.py:42``). Hard labels: ``label`` holds class ids
    with a trailing 1 (``[..., 1]``) or without; rows whose label is
    ``ignore_index`` give 0. Soft labels (``soft_label=True``): ``label``
    is a distribution of logits' shape and the loss is ``-sum(label *
    (logits - logz))``. Returns ``[..., 1]``. Other axes and
    ``return_softmax`` are not ported."""
    if soft_label:
        logz = torch.logsumexp(logits, dim=-1, keepdim=True)
        return -(label * (logits - logz)).sum(dim=-1, keepdim=True)
    if label.ndim > 1 and label.shape[-1] == 1:
        label = label.squeeze(-1)
    logz = torch.logsumexp(logits, dim=-1)
    picked = torch.gather(logits, -1,
                          torch.clamp(label.long(), min=0)[..., None])[..., 0]
    loss = torch.where(label == ignore_index, torch.zeros_like(logz),
                       logz - picked)
    return loss[..., None]
