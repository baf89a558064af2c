"""Loss ops (ref: ``paddle_tpu/ops/loss.py``), registered under the
reference's names.

``nce_loss`` and ``sampled_softmax_with_cross_entropy`` draw their
negatives from an explicit ``torch.Generator`` where the reference takes
a key; each is a draw (``nce_negatives``, ``sampled_negatives``) and a
function of the drawn negatives (``nce_loss_from``,
``sampled_softmax_from``), so a caller can feed in any draw.
``ctc_loss`` is the per-sequence negative log-likelihood that the
reference takes from ``optax.ctc_loss``.
"""

import math

import torch
import torch.nn.functional as F

from paddle_tpu_torch.core.registry import register_op


def _squeeze_label(label):
    if label.ndim > 1 and label.shape[-1] == 1:
        return label.squeeze(-1)
    return label


def _zero(x):
    return torch.zeros((), dtype=x.dtype, device=x.device)


@register_op("cross_entropy")
def cross_entropy(input, label, soft_label=False, ignore_index=-100):
    """``input`` is probabilities (ref: ``ops/loss.py:29``)."""
    if soft_label:
        return -torch.sum(label * torch.log(torch.clamp_min(input, 1e-20)),
                          dim=-1, keepdim=True)
    label = _squeeze_label(label)
    picked = torch.gather(input, -1,
                          torch.clamp_min(label.long(), 0)[..., None])[..., 0]
    loss = -torch.log(torch.clamp_min(picked, 1e-20))
    loss = torch.where(label == ignore_index, _zero(loss), loss)
    return loss[..., None]


@register_op("softmax_with_cross_entropy")
def softmax_with_cross_entropy(logits, label, soft_label=False,
                               ignore_index=-100, axis=-1,
                               return_softmax=False):
    """Softmax cross entropy over ``axis`` in the stable logsumexp form
    (ref: ``ops/loss.py:42``). Hard labels: ``label`` holds class ids with
    a trailing 1 (``[..., 1]``) or without; rows whose label is
    ``ignore_index`` give 0. Soft labels (``soft_label=True``): ``label``
    is a distribution of logits' shape and the loss is ``-sum(label *
    (logits - logz))``. Returns the loss with ``axis`` kept as 1, and the
    softmax too with ``return_softmax``."""
    logz = torch.logsumexp(logits, dim=axis, keepdim=True)
    if soft_label:
        loss = -(label * (logits - logz)).sum(dim=axis, keepdim=True)
    else:
        lbl = _squeeze_label(label)
        picked = torch.gather(logits, axis,
                              torch.clamp(lbl.long(), min=0).unsqueeze(axis))
        nll = (logz - picked).squeeze(axis)
        loss = torch.where(lbl == ignore_index, torch.zeros_like(nll),
                           nll).unsqueeze(-1)
    if return_softmax:
        return loss, torch.exp(logits - logz)
    return loss


@register_op("sigmoid_cross_entropy_with_logits")
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


@register_op("smooth_l1_loss")
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


@register_op("bce_loss")
def bce_loss(input, label):
    return -(label * torch.log(torch.clamp_min(input, 1e-12))
             + (1 - label) * torch.log(torch.clamp_min(1 - input, 1e-12)))


@register_op("log_loss")
def log_loss(input, label, epsilon=1e-4):
    return -(label * torch.log(input + epsilon)
             + (1 - label) * torch.log(1 - input + epsilon))


@register_op("mse_loss")
def mse_loss(input, label):
    return torch.square(input - label)


@register_op("square_error_cost")
def square_error_cost(input, label):
    return torch.square(input - label)


@register_op("l1_loss")
def l1_loss(input, label):
    return torch.abs(input - label)


@register_op("huber_loss")
def huber_loss(input, label, delta=1.0):
    d = torch.abs(label - input)
    return torch.where(d <= delta, 0.5 * torch.square(d),
                       delta * (d - 0.5 * delta))


@register_op("hinge_loss")
def hinge_loss(logits, label):
    """label in {0, 1}."""
    y = 2.0 * label - 1.0
    return torch.clamp_min(1.0 - y * logits, 0.0)


@register_op("rank_loss")
def rank_loss(label, left, right):
    d = left - right
    return (torch.clamp_min(d, 0.0) - d * label
            + torch.log1p(torch.exp(-torch.abs(d))))


@register_op("margin_rank_loss")
def margin_rank_loss(label, left, right, margin=0.1):
    return torch.clamp_min(-label * (left - right) + margin, 0.0)


@register_op("bpr_loss")
def bpr_loss(input, label):
    """Bayesian personalized ranking over softmax inputs."""
    lbl = _squeeze_label(label)
    pos = torch.gather(input, -1, lbl.long()[..., None])
    n = input.shape[-1]
    return -torch.sum(torch.log(torch.sigmoid(pos - input)), dim=-1,
                      keepdim=True) / (n - 1)


@register_op("kldiv_loss")
def kldiv_loss(x, target, reduction="mean"):
    """x is log-probabilities."""
    loss = target * (torch.log(torch.clamp_min(target, 1e-20)) - x)
    loss = torch.where(target > 0, loss, _zero(loss))
    if reduction == "mean":
        return torch.mean(loss)
    if reduction == "sum":
        return torch.sum(loss)
    if reduction == "batchmean":
        return torch.sum(loss) / x.shape[0]
    return loss


@register_op("npair_loss")
def npair_loss(anchor, positive, labels, l2_reg=0.002):
    sim = anchor @ positive.T
    lbl = labels.reshape(-1)
    targets = (lbl[:, None] == lbl[None, :]).to(sim.dtype)
    targets = targets / torch.sum(targets, dim=1, keepdim=True)
    logz = torch.logsumexp(sim, dim=1, keepdim=True)
    ce = torch.mean(-torch.sum(targets * (sim - logz), dim=1))
    reg = l2_reg * (torch.mean(torch.sum(torch.square(anchor), 1))
                    + torch.mean(torch.sum(torch.square(positive), 1))) / 2
    return ce + reg


@register_op("cos_sim")
def cos_sim(x, y, epsilon=1e-12):
    xn = torch.sqrt(torch.sum(torch.square(x), -1, keepdim=True) + epsilon)
    yn = torch.sqrt(torch.sum(torch.square(y), -1, keepdim=True) + epsilon)
    return torch.sum(x * y, -1, keepdim=True) / (xn * yn)


@register_op("ctc_loss")
def ctc_loss(logits, logit_lengths, labels, label_lengths, blank=0):
    """CTC negative log-likelihood per sequence ``[B]`` (ref:
    ``ops/loss.py:203``, ``optax.ctc_loss``): logits ``[B, T, C]``
    unnormalized, labels ``[B, L]`` padded past ``label_lengths``."""
    log_probs = torch.log_softmax(logits.to(torch.float32), dim=-1)
    return F.ctc_loss(log_probs.transpose(0, 1), labels.long(),
                      logit_lengths.long(), label_lengths.long(),
                      blank=blank, reduction="none").to(logits.dtype)


def nce_negatives(generator, batch, num_neg_samples, num_total_classes):
    """``[batch, num_neg_samples]`` class ids uniform over the classes."""
    return torch.randint(0, num_total_classes, (batch, num_neg_samples),
                         generator=generator, device=generator.device)


def nce_loss_from(input, label, weight, bias, neg, num_total_classes):
    """NCE with uniform noise q = 1/C over the drawn negatives ``neg``
    ``[B, K]`` (ref: ``ops/loss.py:218``); input ``[B, D]``, label
    ``[B]``, weight ``[C, D]``, bias ``[C]`` -> ``[B, 1]``."""
    label = _squeeze_label(label).long()
    neg = neg.long()
    pos_logit = torch.sum(input * weight[label], -1) + bias[label]
    neg_logit = torch.einsum("bd,bkd->bk", input, weight[neg]) + bias[neg]
    log_q = -math.log(float(num_total_classes))
    pos_loss = -F.logsigmoid(pos_logit - log_q)
    neg_loss = -torch.sum(F.logsigmoid(-(neg_logit - log_q)), -1)
    return (pos_loss + neg_loss)[:, None]


@register_op("nce_loss")
def nce_loss(generator, input, label, weight, bias, num_total_classes,
             num_neg_samples=10):
    """NCE with uniform negative sampling (ref: ``ops/loss.py:218``)."""
    neg = nce_negatives(generator, input.shape[0], num_neg_samples,
                        num_total_classes)
    return nce_loss_from(input, label, weight, bias, neg, num_total_classes)


def sampled_negatives(generator, num_samples, num_total_classes):
    """``[num_samples]`` class ids uniform over the classes."""
    return torch.randint(0, num_total_classes, (num_samples,),
                         generator=generator, device=generator.device)


def sampled_softmax_from(logits_weight, logits_bias, input, label, neg):
    """Softmax cross entropy over the batch's own labels and the drawn
    classes ``neg`` (ref: ``ops/loss.py:241``) -> ``[B, 1]``."""
    b = input.shape[0]
    classes = torch.cat([_squeeze_label(label).long(), neg.long()])
    logit = input @ logits_weight[classes].T + logits_bias[classes]
    logz = torch.logsumexp(logit, -1)
    picked = logit[torch.arange(b, device=logit.device),
                   torch.arange(b, device=logit.device)]
    return (logz - picked)[:, None]


@register_op("sampled_softmax_with_cross_entropy")
def sampled_softmax_with_cross_entropy(generator, logits_weight, logits_bias,
                                       input, label, num_samples,
                                       num_total_classes):
    neg = sampled_negatives(generator, num_samples, num_total_classes)
    return sampled_softmax_from(logits_weight, logits_bias, input, label, neg)


@register_op("center_loss")
def center_loss(features, label, centers, alpha=0.5):
    """Returns ``(loss, new_centers)`` (ref: ``ops/loss.py:259``)."""
    label = _squeeze_label(label).long()
    c = centers[label]
    loss = 0.5 * torch.sum(torch.square(features - c), dim=-1, keepdim=True)
    counts = torch.zeros(centers.shape[0], dtype=features.dtype,
                         device=features.device).index_add(
        0, label, torch.ones_like(label, dtype=features.dtype))
    upd = torch.zeros_like(centers).index_add(0, label, c - features)
    return loss, centers - alpha * upd / (counts[:, None] + 1.0)


@register_op("dice_loss")
def dice_loss(input, label, epsilon=1e-5):
    label = _squeeze_label(label).to(input.dtype)
    if label.ndim < input.ndim:
        label = F.one_hot(label.long(), input.shape[-1]).to(input.dtype)
    red = tuple(range(1, input.ndim))
    inter = torch.sum(input * label, red)
    union = torch.sum(input, red) + torch.sum(label, red)
    return torch.mean(1.0 - (2 * inter + epsilon) / (union + epsilon))


@register_op("hsigmoid")
def hsigmoid_loss(x, weight, label, num_classes, bias=None):
    """Hierarchical sigmoid over the default complete binary tree (ref:
    ``ops/loss.py:285``): class c encodes as v = c + num_classes; the
    path's node rows are ``(v >> (bit + 1)) - 1`` and its targets v's low
    bits; every path is padded to the longest and masked by its length.
    x ``[B, D]``, weight ``[num_classes - 1, D]`` -> ``[B]``."""
    v = label.long() + num_classes
    max_len = int((2 * num_classes - 1).bit_length() - 1)
    bits = torch.arange(max_len, device=x.device)
    lengths = torch.sum(
        (v[:, None] >> torch.arange(1, max_len + 2, device=x.device)[None])
        > 0, dim=1)
    valid = bits[None, :] < lengths[:, None]
    idx = torch.clamp((v[:, None] >> (bits[None, :] + 1)) - 1, 0,
                      num_classes - 2)
    target = ((v[:, None] >> bits[None, :]) & 1).to(x.dtype)
    pre = torch.einsum("bd,bld->bl", x, weight[idx])
    if bias is not None:
        pre = pre + bias[idx]
    per_bit = (torch.clamp_min(pre, 0) - pre * target
               + torch.log1p(torch.exp(-torch.abs(pre))))
    return torch.sum(torch.where(valid, per_bit, _zero(per_bit)), dim=1)
