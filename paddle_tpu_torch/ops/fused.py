"""Fused cross-entropy over the vocab axis (ref: ``paddle_tpu/ops/fused.py``
:31-206 and ``fused_xent`` :346).

``softmax_with_cross_entropy(h @ W.T, y)`` would materialize ``[rows, V]``
f32 logits only to reduce them to one scalar per row. :func:`fused_xent`
fuses the vocab projection into the loss: K5 computes the per-row
``(m, s, picked, sum_logits)`` over vocab tiles, the smoothed-CE loss
follows in closed form from them, and the backward (K6) recomputes the
dlogits tile by tile from the saved ``logz`` instead of storing them. On
CPU tensors the kernels' plain versions (the reference's chunked XLA
formulation) run instead.

Ported for one device and the tied ``[V, H]`` ("vh") weight layout; the
vocab-sharded path and the ``[H, V]`` ("hv") layout wait for multi-GPU and
raise ``NotImplementedError``.
"""

import torch

from paddle_tpu_torch.ops.cuda.xent import xent_bwd, xent_stats


def _loss_from_stats(logz, picked, sl, v, ls):
    """The smoothed-CE closed form from the three per-row reductions
    (ref: ``ops/fused.py:112``)."""
    if ls:
        sn = ls / (v - 1)
        sp = 1.0 - ls
        return (sp - sn) * (logz - picked) + sn * (v * logz - sl)
    return logz - picked


def _smooth_consts(v, ls):
    sn = ls / (v - 1) if ls else 0.0
    sp = 1.0 - ls if ls else 1.0
    return sn, sp


class FusedXentFunction(torch.autograd.Function):
    """Per-row loss of ``[N, H]`` hidden rows against the ``[V, H]``
    weight (the reference's ``_fused_xent_rows`` custom_vjp). The
    gradients come back in the dtypes of h, W and b, as ``_fx_bwd``
    casts them."""

    @staticmethod
    def forward(ctx, h, w, b, labels, ls):
        m, s, picked, sl = xent_stats(h, w, b, labels)
        logz = m + torch.log(s)
        ctx.save_for_backward(h, w, b, labels, logz)
        ctx.ls = ls
        return _loss_from_stats(logz, picked, sl, w.shape[0], ls)

    @staticmethod
    def backward(ctx, g):
        h, w, b, labels, logz = ctx.saved_tensors
        sn, sp = _smooth_consts(w.shape[0], ctx.ls)
        dh, dw, db = xent_bwd(h, w, b, labels, logz, g.float().contiguous(),
                              sn, sp)
        return (dh.to(h.dtype), dw.to(w.dtype),
                None if b is None else db.to(b.dtype), None, None)


def fused_xent(hidden, weight, labels, bias=None, weight_layout="vh",
               label_smoothing=0.0, vocab_axis=None, batch_axis=None,
               mesh=None):
    """Per-position softmax cross entropy without materializing logits.

    hidden ``[..., H]``; weight ``[V, H]`` (the tied-embedding layout);
    labels ``[...]`` int; bias ``[V]`` optional (f32). Returns the f32
    loss with labels' shape, equal to
    ``softmax_with_cross_entropy(hidden @ weight.T + bias, labels)`` (the
    label-smoothed soft-label form when ``label_smoothing > 0``). The
    kernels tile the vocab themselves; the plain versions take the
    reference's default chunk of 8192."""
    if weight_layout != "vh":
        raise NotImplementedError(
            f"fused_xent: weight_layout={weight_layout!r} is not ported "
            "(the tied [V, H] layout 'vh' is)")
    if vocab_axis is not None or batch_axis is not None or mesh is not None:
        raise NotImplementedError(
            "fused_xent: the vocab-sharded path is not ported")
    lead = labels.shape
    h2 = hidden.reshape(-1, hidden.shape[-1]).contiguous()
    lbl = labels.reshape(-1)
    b = bias.float() if bias is not None else None
    loss = FusedXentFunction.apply(h2, weight.contiguous(), b, lbl,
                                   float(label_smoothing))
    return loss.reshape(lead)
