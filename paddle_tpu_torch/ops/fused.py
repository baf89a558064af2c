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

The ``[H, V]`` ("hv") layout of an output projection (the Transformer's
``out_proj``) takes the reference's chunked XLA formulation in plain
torch on every device, as the reference runs no Pallas kernel for it
(``paddle_tpu/ops/fused.py:127``): an online ``(m, s, picked, sum)`` over
chunks of vocab columns, and a backward that recomputes each chunk's
logits from the saved ``logz``. The products promote as jnp does: f32
hidden rows against a bf16 weight give f32 logits. The vocab-sharded path
waits for multi-GPU and raises ``NotImplementedError``.
"""

import torch

from paddle_tpu_torch.core.registry import register_op
from paddle_tpu_torch.ops.cuda.xent import xent_bwd, xent_stats

#: the reference's default vocab chunk of the hv layout (its
#: ``xent_chunk`` flag, ``paddle_tpu/core/flags.py:94``)
XENT_CHUNK = 8192


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


def _vocab_chunks(v, chunk):
    return [(c0, min(c0 + chunk, v)) for c0 in range(0, v, chunk)]


def _hv_logits(h32, w, b, c0, c1):
    """f32 logits of vocab columns ``[c0, c1)`` from the f32 rows and the
    ``[H, V]`` weight (its chunk widened to f32 exactly, as jnp promotes
    an f32 · bf16 product), plus the f32 bias."""
    logits = h32 @ w[:, c0:c1].float()
    return logits if b is None else logits + b[c0:c1][None, :]


def _hv_stats(h32, w, b, labels, chunk, need_sum):
    """Per row: ``logz``, the label's logit (0 for a label outside the
    vocab) and, with ``need_sum``, the sum of the logits, by an online
    logsumexp over vocab chunks (ref: ``ops/fused.py:75``)."""
    n = h32.shape[0]
    dev = h32.device
    m = torch.full((n,), float("-inf"), device=dev)
    s = torch.zeros(n, device=dev)
    picked = torch.zeros(n, device=dev)
    sl = torch.zeros(n, device=dev)
    for c0, c1 in _vocab_chunks(w.shape[1], chunk):
        logits = _hv_logits(h32, w, b, c0, c1)
        m_new = torch.maximum(m, logits.amax(dim=1))
        s = s * torch.exp(m - m_new) + torch.exp(
            logits - m_new[:, None]).sum(dim=1)
        m = m_new
        local = labels - c0
        inr = (local >= 0) & (local < c1 - c0)
        got = torch.gather(logits, 1, local.clamp(0, c1 - c0 - 1)[:, None])
        picked = picked + torch.where(inr, got[:, 0],
                                      torch.zeros_like(picked))
        if need_sum:
            sl = sl + logits.sum(dim=1)
    return m + torch.log(s), picked, sl


class HvXentFunction(torch.autograd.Function):
    """Per-row loss of ``[N, H]`` rows against an ``[H, V]`` weight, the
    reference's chunked ``_fused_xent_rows`` for ``layout="hv"``. The
    backward recomputes each chunk's logits from ``logz`` (ref:
    ``ops/fused.py:159-186``) and returns the gradients in the dtypes of
    h, W and b."""

    @staticmethod
    def forward(ctx, h, w, b, labels, ls, chunk):
        h32 = h.float()
        logz, picked, sl = _hv_stats(h32, w, b, labels, chunk, ls != 0.0)
        ctx.save_for_backward(h, w, b, labels, logz)
        ctx.ls, ctx.chunk = ls, chunk
        return _loss_from_stats(logz, picked, sl, w.shape[1], ls)

    @staticmethod
    def backward(ctx, g):
        h, w, b, labels, logz = ctx.saved_tensors
        sn, sp = _smooth_consts(w.shape[1], ctx.ls)
        h32, g = h.float(), g.float()
        dh = torch.zeros_like(h32)
        dw = torch.empty(w.shape, dtype=torch.float32, device=w.device)
        db = torch.empty(w.shape[1], dtype=torch.float32, device=w.device)
        for c0, c1 in _vocab_chunks(w.shape[1], ctx.chunk):
            p = torch.exp(_hv_logits(h32, w, b, c0, c1) - logz[:, None])
            col = torch.arange(c0, c1, device=labels.device)
            hit = (col[None, :] == labels[:, None]).to(torch.float32)
            # dlogits of the smoothed CE: softmax - smoothed one-hot
            gch = (p - sn - (sp - sn) * hit) * g[:, None]
            dh += gch @ w[:, c0:c1].float().T
            dw[:, c0:c1] = h32.T @ gch
            db[c0:c1] = gch.sum(dim=0)
        return (dh.to(h.dtype), dw.to(w.dtype),
                None if b is None else db.to(b.dtype), None, None, None)


@register_op("fused_xent")
def fused_xent(hidden, weight, labels, bias=None, weight_layout="vh",
               label_smoothing=0.0, chunk=None, vocab_axis=None,
               batch_axis=None, mesh=None):
    """Per-position softmax cross entropy without materializing logits.

    hidden ``[..., H]``; weight ``[V, H]`` ("vh", the tied-embedding
    layout: K5 forward and K6 backward on the card) or ``[H, V]`` ("hv",
    an output projection: the chunked plain torch path on every device);
    labels ``[...]`` int; bias ``[V]`` optional (f32). Returns the f32
    loss with labels' shape, equal to
    ``softmax_with_cross_entropy(project(hidden) + bias, labels)`` (the
    label-smoothed soft-label form when ``label_smoothing > 0``). ``chunk``
    is the hv path's vocab chunk (default :data:`XENT_CHUNK`); the vh
    kernels tile the vocab themselves, and their plain versions take
    8192."""
    if weight_layout not in ("vh", "hv"):
        raise ValueError(f"fused_xent: weight_layout {weight_layout!r} "
                         "(vh or hv)")
    if vocab_axis is not None or batch_axis is not None or mesh is not None:
        raise NotImplementedError(
            "fused_xent: the vocab-sharded path is not ported")
    lead = labels.shape
    h2 = hidden.reshape(-1, hidden.shape[-1]).contiguous()
    lbl = labels.reshape(-1)
    b = bias.float() if bias is not None else None
    if weight_layout == "hv":
        loss = HvXentFunction.apply(h2, weight, b, lbl.long(),
                                    float(label_smoothing),
                                    int(chunk or XENT_CHUNK))
    else:
        loss = FusedXentFunction.apply(h2, weight.contiguous(), b, lbl,
                                       float(label_smoothing))
    return loss.reshape(lead)


def register_fused_aliases():
    """The reference's fused-op aliases whose base op covers the fused
    semantics (ref: ``ops/fused.py:603``); one whose target the port
    lacks (``conv_fusion``) is skipped."""
    from paddle_tpu_torch.ops.tail import _alias
    for name, target in (
            ("fusion_gru", "gru"),
            ("fusion_lstm", "lstm"),
            ("fusion_conv_inception", "conv_fusion"),
            ("multihead_matmul", "multihead_attention")):
        _alias(name, target)
