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

The rest of the reference's fused surface (``ops/fused.py:370-600``) is
each op's composition in plain torch, as the reference writes each as
one XLA composition; ``fused_fc_elementwise_layernorm`` is the one that
reaches a kernel: its add and layer norm are K8.
"""

import math
import os

import torch

from paddle_tpu_torch.core.enforce import enforce
from paddle_tpu_torch.core.registry import register_op
from paddle_tpu_torch.core.settings import env_default
from paddle_tpu_torch.ops import activations
from paddle_tpu_torch.ops.cuda.layer_norm import add_layer_norm_fused
from paddle_tpu_torch.ops.cuda.xent import xent_bwd, xent_stats
from paddle_tpu_torch.ops.nn import matmul

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


def fused_xent_enabled():
    """Whether models take :func:`fused_xent` for their vocab loss (ref:
    ``ops/fused.py:45``): ``PT_FUSED_XENT`` (the documented spelling)
    wins, else the ``fused_xent`` setting (``PT_FLAGS_fused_xent``, on by
    default), read from the environment at each call."""
    env = os.environ.get("PT_FUSED_XENT")
    if env is not None:
        return env.lower() in ("1", "true", "yes")
    return env_default("fused_xent", True)


def _act(name, x):
    if name in (None, "", "identity"):
        return x
    return getattr(activations, name)(x)


@register_op("fused_elemwise_activation")
def fused_elemwise_activation(x, y, functor_list=("elementwise_add", "relu"),
                              scale=1.0):
    """The reference's composition rules (ref: ``ops/fused.py:370``):
    ``[binary, unary]`` is ``Binary(x, Unary(y))``, ``[unary, binary]`` is
    ``Unary(Binary(x, y))``; binaries add and mul, unaries relu and
    scale."""
    binary_fns = {"elementwise_add": torch.add,
                  "elementwise_mul": torch.mul}

    def unary(name, t):
        if name == "relu":
            return activations.relu(t)
        if name == "scale":
            return t * scale
        enforce(False, f"unsupported unary functor '{name}' "
                       "(reference supports relu, scale)")

    f0, f1 = functor_list
    if f0 in binary_fns:
        return binary_fns[f0](x, unary(f1, y))
    enforce(f1 in binary_fns,
            f"functor_list {functor_list} has no binary functor")
    return unary(f0, binary_fns[f1](x, y))


def _length_mask(lengths, t, like):
    return (torch.arange(t, device=like.device)[None, :]
            < lengths[:, None]).to(like.dtype)


@register_op("fused_embedding_seq_pool")
def fused_embedding_seq_pool(table, ids, lengths=None, combiner="sum"):
    """Lookup, then each sequence's sum (or mean) over its ``lengths``
    (ref: ``ops/fused.py:398``); ids ``[B, T]`` padded."""
    emb = table[ids.long()]
    if lengths is not None:
        emb = emb * _length_mask(lengths, ids.shape[1], emb)[..., None]
    out = emb.sum(1)
    if combiner == "mean":
        n = (torch.clamp(lengths, min=1)[:, None].to(out.dtype)
             if lengths is not None else float(ids.shape[1]))
        out = out / n
    return out


@register_op("fused_fc_elementwise_layernorm")
def fused_fc_elementwise_layernorm(x, w, y, bias=None, scale=None,
                                   shift=None, epsilon=1e-5):
    """``layer_norm(x @ w + bias + y)`` over the last axis (ref:
    ``ops/fused.py:449``). The product is ``torch.matmul``; the add and
    the layer norm are K8 (``add_layer_norm_fused``: one launch a call on
    the card, the sum kept in f32 as the reference's op keeps it), the
    plain version on the CPU."""
    h = matmul(x, w)
    if bias is not None:
        h = h + bias
    return add_layer_norm_fused(h, y.expand_as(h).to(h.dtype), scale, shift,
                                begin_norm_axis=h.ndim - 1, epsilon=epsilon)


@register_op("fusion_repeated_fc_relu")
def fusion_repeated_fc_relu(x, weights, biases):
    """A chain of fc + relu (ref: ``ops/fused.py:467``)."""
    h = x
    for w, b in zip(weights, biases):
        h = activations.relu(matmul(h, w) + b)
    return h


@register_op("fusion_squared_mat_sub")
def fusion_squared_mat_sub(x, y, scalar=1.0):
    """``((x @ y)^2 - (x^2 @ y^2)) * scalar`` (ref: ``ops/fused.py:476``)."""
    xy = matmul(x, y)
    return (xy * xy - matmul(x * x, y * y)) * scalar


@register_op("fusion_transpose_flatten_concat")
def fusion_transpose_flatten_concat(inputs, trans_axis, flatten_axis,
                                    concat_axis=0):
    """Each input transposed, flattened from ``flatten_axis``, then all
    concatenated (ref: ``ops/fused.py:484``)."""
    outs = []
    for t in inputs:
        t = t.permute(tuple(trans_axis))
        lead = 1
        for d in t.shape[:flatten_axis]:
            lead *= int(d)
        outs.append(t.reshape(lead, -1))
    return torch.cat(outs, concat_axis)


@register_op("fusion_seqpool_concat")
def fusion_seqpool_concat(inputs, lengths=None, pooltype="SUM"):
    """Each ``[B, T, D]`` input pooled over its sequence (SUM, AVERAGE or
    SQRT), then concatenated along features (ref: ``ops/fused.py:499``)."""
    pooled = []
    for x in inputs:
        n = (torch.clamp(lengths, min=1)[:, None].to(x.dtype)
             if lengths is not None else float(x.shape[1]))
        if lengths is not None:
            x = x * _length_mask(lengths, x.shape[1], x)[..., None]
        s = x.sum(1)
        if pooltype == "AVERAGE":
            s = s / n
        elif pooltype == "SQRT":
            s = s / (torch.sqrt(n) if isinstance(n, torch.Tensor)
                     else math.sqrt(n))
        pooled.append(s)
    return torch.cat(pooled, -1)


@register_op("fusion_seqpool_cvm_concat")
def fusion_seqpool_cvm_concat(inputs, lengths=None, use_cvm=True,
                              pooltype="SUM"):
    """Sequence pool, the CVM transform, concat (ref:
    ``ops/fused.py:523``)."""
    from paddle_tpu_torch.ops.tail import continuous_value_model
    return torch.cat([continuous_value_model(
        fusion_seqpool_concat([x], lengths, pooltype=pooltype),
        use_cvm=use_cvm) for x in inputs], -1)


@register_op("fusion_seqexpand_concat_fc")
def fusion_seqexpand_concat_fc(seq_input, static_inputs, w, bias=None,
                               act="relu"):
    """Per-batch static features broadcast along the sequence, concatenated
    with it, one fc and the activation (ref: ``ops/fused.py:536``)."""
    b, t, _ = seq_input.shape
    parts = [seq_input] + [s[:, None, :].expand(b, t, s.shape[-1])
                           for s in static_inputs]
    h = matmul(torch.cat(parts, -1), w)
    if bias is not None:
        h = h + bias
    return _act(act, h)


@register_op("fusion_seqconv_eltadd_relu")
def fusion_seqconv_eltadd_relu(x, w, b, context_length, context_start=None,
                               lengths=None):
    """``relu(sequence_conv(x) + b)`` over padded ``[B, T, D]`` (ref:
    ``ops/fused.py:553``): the window rows outside ``[0, length)`` are
    zeros."""
    start = (-((context_length - 1) // 2) if context_start is None
             else context_start)
    n, t, _ = x.shape
    if lengths is None:
        lengths = torch.full((n,), t, dtype=torch.int32, device=x.device)
    mask = torch.arange(t, device=x.device)[None, :] < lengths[:, None]
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    xm = torch.where(mask[..., None], x, zero)
    cols = []
    for k in range(context_length):
        off = start + k
        shifted = torch.roll(xm, -off, 1)
        pos = torch.arange(t, device=x.device) + off
        valid = (pos >= 0)[None, :] & (pos[None, :] < lengths[:, None])
        cols.append(torch.where(valid[..., None], shifted, zero))
    ctx = torch.cat(cols, -1)
    return activations.relu(matmul(ctx, w) + b)


@register_op("conv_fusion")
def conv_fusion(x, weight, bias=None, residual=None, stride=1, padding=0,
                dilation=1, groups=1, activation="relu",
                data_format="NCHW"):
    """``activation(conv(x, w) + bias + residual)`` (ref:
    ``ops/fused.py:578``)."""
    from paddle_tpu_torch.ops.nn import conv2d
    out = conv2d(x, weight, bias, stride, padding, dilation, groups,
                 data_format=data_format)
    if residual is not None:
        out = out + residual
    return _act(None if activation == "identity" else activation, out)


@register_op("fused_embedding_fc_lstm")
def fused_embedding_fc_lstm(ids, embeddings, h0, c0, w_hh, bias=None,
                            lengths=None):
    """An LSTM whose input projection is pre-folded into the table (ref:
    ``ops/fused.py:590``): ``embeddings [V, 4H]`` is the table times the
    input weight, so the lookup is the x-projection, fed to ``ops.rnn``'s
    LSTM through an identity input weight. One Python step a time step."""
    from paddle_tpu_torch.ops.rnn import lstm
    xproj = embeddings[ids.long()]
    ident = torch.eye(xproj.shape[-1], dtype=xproj.dtype,
                      device=xproj.device)
    return lstm(xproj, h0, c0, ident, w_hh, b=bias, lengths=lengths)


def register_fused_aliases():
    """The reference's fused-op aliases whose base op covers the fused
    semantics (ref: ``ops/fused.py:603``)."""
    from paddle_tpu_torch.ops.tail import _alias
    for name, target in (
            ("fusion_gru", "gru"),
            ("fusion_lstm", "lstm"),
            ("fusion_conv_inception", "conv_fusion"),
            ("multihead_matmul", "multihead_attention")):
        _alias(name, target)
