"""Loss ops (the slices' subset of ``paddle_tpu/ops/loss.py``)."""

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


def sigmoid_cross_entropy_with_logits(x, label, ignore_index=-100,
                                      normalize=False):
    """Elementwise logistic loss in the reference's stable form (ref:
    ``ops/loss.py:66``): ``max(x, 0) - x * label + log1p(exp(-|x|))``;
    entries whose label is ``ignore_index`` give 0, and ``normalize``
    divides by the count of the others (at least 1).

    The gradient at exactly ``x == 0`` is the reference's: ``jnp.maximum``
    splits its gradient there (0.5, as ``torch.maximum`` does) and
    ``jnp.abs``'s gradient at 0 is +1, where ``torch.abs``'s is 0; so
    ``|x|`` is written as ``where(x >= 0, x, -x)``. With label 1 the
    gradient at 0 is -1.0 and with label 0 it is 0.0 (``torch.abs`` or
    ``binary_cross_entropy_with_logits`` give -0.5 and 0.5)."""
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    abs_x = torch.where(x >= 0, x, -x)
    loss = torch.maximum(x, zero) - x * label + torch.log1p(torch.exp(-abs_x))
    valid = label != ignore_index
    loss = torch.where(valid, loss, zero)
    if normalize:
        loss = loss / torch.clamp(valid.to(loss.dtype).sum(), min=1.0)
    return loss


def smooth_l1_loss(x, y, sigma=1.0):
    """Smooth L1, summed over every axis but the first (kept as 1); a 1-D
    input gives the elementwise loss (ref: ``ops/loss.py:107``)."""
    sigma2 = sigma * sigma
    diff = x - y
    absd = torch.abs(diff)
    loss = torch.where(absd < 1.0 / sigma2, 0.5 * sigma2 * torch.square(diff),
                       absd - 0.5 / sigma2)
    if x.ndim > 1:
        return torch.sum(loss, dim=tuple(range(1, x.ndim)), keepdim=True)
    return loss
