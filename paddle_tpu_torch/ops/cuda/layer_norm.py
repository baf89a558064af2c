"""K1 (layer norm) and K8 (fused residual add + layer norm) — the CUDA
forward kernels, their plain PyTorch versions, and the differentiable ops
around them.

Replaces ``paddle_tpu/ops/pallas/layer_norm.py:30 _ln_fwd_kernel``
(launcher ``_stats_pallas`` :62, entry ``layer_norm_fused`` :148).
Source: ``paddle_tpu_torch/csrc/layer_norm.cu``. One warp normalizes one
row of ``[R, C]``; statistics are f32; the kernel also writes the f32
mean and rstd per row, which the backward reads. Bound on the H100: bytes
(one read of x, one write of y), and at decode's 8 rows the latency of
one row. Two routes, chosen by :func:`ln_route` from the dtype and C:
``"row"`` holds the row in registers, loaded once in 16-byte packs (C a
multiple of the pack, at most 8 packs a lane: C <= 2048 in bf16, 1024 in
f32); ``"simt"``, the first port, reads the row three times.

K8 replaces ``:175 _ln_add_fwd_kernel`` (launcher ``_stats_add_pallas``
:190, entry ``add_layer_norm_fused`` :263): ``ln(x + h)`` with the sum
formed once in f32 and kept in shared memory for the three passes, never
rounded to the storage type (the reference's XLA twin ``_stats_add``
rounds it to x's dtype first; in f32 the two agree, in bf16 they differ
by that one rounding). Bound on the H100: bytes (one read of x and h, one
write of y). The scale and bias may have another type than the rows (f32
rows with bf16 parameters: the Transformer under the bf16 policy, whose
activations the reference promotes to f32); the kernel widens them to f32
as the Pallas kernel does (``:175-188``), and rounds no f32 operand.

The backwards are the reference's ``_ln_bwd`` (:131) and ``_aln_bwd``
(:245) in plain torch, from the saved mean and rstd: the JAX package has
no backward kernel for layer norm, so neither has the port.

On the card both kernels are reached through their ops,
``torch.ops.paddle_tpu_torch.layer_norm`` and ``.add_layer_norm``
(``core.define_op``), which return ``(y, mean, rstd)`` as the plain
versions do. The gradients stay with :class:`LayerNormFunction` and
:class:`AddLayerNormFunction` around the ops, as the reference's
custom_vjps are: ``make_fx`` records their backward ops and
``torch.export`` inlines their forward.
"""

import torch

from paddle_tpu_torch.ops.cuda import core

KERNEL = core.register(
    "layer_norm", "ptt_layer_norm",
    [core.I32, core.VP, core.VP, core.VP, core.VP, core.VP, core.VP,
     core.I32, core.I32, core.F32_ARG, core.VP],
    replaces="paddle_tpu/ops/pallas/layer_norm.py:30",
    source="paddle_tpu_torch/csrc/layer_norm.cu",
    routes={"row": ("ptt_layer_norm_row",
                    [core.I32, core.VP, core.VP, core.VP, core.VP, core.VP,
                     core.VP, core.I32, core.I32, core.F32_ARG, core.VP])})
KERNEL_ADD = core.register(
    "add_layer_norm", "ptt_add_layer_norm",
    [core.I32, core.I32] + [core.VP] * 7 + [core.I32, core.I32,
                                            core.F32_ARG, core.VP],
    replaces="paddle_tpu/ops/pallas/layer_norm.py:175",
    source="paddle_tpu_torch/csrc/layer_norm.cu")


#: the row route: 16-byte packs a lane may hold (csrc/layer_norm.cu)
ROW_MAX_PACKS = 8


def ln_route(dtype, cols):
    """K1's route: ``"row"`` when a row is whole 16-byte packs, at most
    :data:`ROW_MAX_PACKS` of them a lane of a warp, else ``"simt"``."""
    vec = 16 // (4 if dtype == torch.float32 else 2)
    if cols > 0 and cols % vec == 0 and cols <= 32 * vec * ROW_MAX_PACKS:
        return "row"
    return "simt"


def layer_norm_plain(x2d, gamma, beta, epsilon):
    """The plain version: ``(y, mean, rstd)`` with mean/rstd ``[R, 1]``
    f32, exactly the reference's ``_stats_xla``."""
    x = x2d.float()
    m = x.mean(dim=1, keepdim=True)
    xc = x - m
    v = (xc * xc).mean(dim=1, keepdim=True)
    r = torch.rsqrt(v + epsilon)
    y = xc * r
    y = y * gamma.float()[None, :] + beta.float()[None, :]
    return y.to(x2d.dtype), m, r


def _stats_like(x2d):
    """The fake outputs of K1 and K8: ``y`` like ``x2d``, mean and rstd
    ``[R, 1]`` f32."""
    stat = x2d.new_empty((x2d.shape[0], 1), dtype=torch.float32)
    return torch.empty_like(x2d), stat, torch.empty_like(stat)


def _layer_norm_cuda(x2d, gamma, beta, epsilon):
    """K1's op on CUDA tensors: launch on the route :func:`ln_route`
    picks."""
    code = core.dtype_code(x2d, (torch.float32, torch.bfloat16))
    if gamma.dtype != x2d.dtype or beta.dtype != x2d.dtype:
        raise TypeError("layer_norm kernel: scale and bias must have x's "
                        f"dtype {x2d.dtype}")
    core.require_contiguous(x=x2d, gamma=gamma, beta=beta)
    r_, c_ = x2d.shape
    if gamma.shape != (c_,) or beta.shape != (c_,):
        raise ValueError(f"scale/bias must be [{c_}]")
    y = torch.empty_like(x2d)
    mean = torch.empty((r_, 1), dtype=torch.float32, device=x2d.device)
    rstd = torch.empty((r_, 1), dtype=torch.float32, device=x2d.device)
    if r_ == 0:
        return y, mean, rstd
    route = ln_route(x2d.dtype, c_)
    if route == "row":
        # 16-byte packs: an operand that does not start on 16 bytes is
        # copied (a fresh allocation does)
        x2d, gamma, beta = (t if t.data_ptr() % 16 == 0 else t.clone()
                            for t in (x2d, gamma, beta))
    KERNEL(code, core.ptr(x2d), core.ptr(gamma), core.ptr(beta),
           core.ptr(y), core.ptr(mean), core.ptr(rstd), r_, c_,
           float(epsilon), core.stream(x2d), route=route)
    return y, mean, rstd


LAYER_NORM_OP = core.define_op(
    KERNEL, "(Tensor x, Tensor gamma, Tensor beta, float epsilon) -> "
    "(Tensor, Tensor, Tensor)", _layer_norm_cuda,
    lambda x2d, gamma, beta, epsilon: _stats_like(x2d))


def layer_norm_kernel(x2d, gamma, beta, epsilon):
    """K1 on CUDA tensors, through its op; same outputs as the plain
    version."""
    return LAYER_NORM_OP(x2d, gamma, beta, float(epsilon))


def layer_norm_rows(x2d, gamma, beta, epsilon=1e-5):
    """``(y, mean, rstd)`` over the rows of ``x2d``: K1 on a CUDA tensor,
    the plain version on a CPU tensor. Not differentiable; see
    :class:`LayerNormFunction`."""
    if core.on_card(x2d, gamma, beta):
        return layer_norm_kernel(x2d, gamma, beta, epsilon)
    return layer_norm_plain(x2d, gamma, beta, epsilon)


def layer_norm_bwd(x2d, gamma, mean, rstd, dy):
    """The reference's ``_ln_bwd``: ``(dx, dgamma, dbeta)`` from the saved
    f32 statistics, in the dtypes of x and gamma."""
    x = x2d.float()
    dy = dy.float()
    xhat = (x - mean) * rstd
    dgamma = (dy * xhat).sum(dim=0).to(gamma.dtype)
    dbeta = dy.sum(dim=0).to(gamma.dtype)
    wdy = dy * gamma.float()[None, :]
    c1 = wdy.mean(dim=1, keepdim=True)
    c2 = (wdy * xhat).mean(dim=1, keepdim=True)
    dx = (wdy - c1 - xhat * c2) * rstd
    return dx.to(x2d.dtype), dgamma, dbeta


class LayerNormFunction(torch.autograd.Function):
    """Layer norm over the rows of ``x2d`` as one differentiable op (the
    reference's ``_layer_norm_rows`` custom_vjp): K1 forward on CUDA
    tensors, the plain forward on CPU tensors, the plain backward on
    both."""

    @staticmethod
    def forward(ctx, x2d, gamma, beta, epsilon):
        y, mean, rstd = layer_norm_rows(x2d, gamma, beta, epsilon)
        ctx.save_for_backward(x2d, gamma, mean, rstd)
        return y

    @staticmethod
    def backward(ctx, dy):
        x2d, gamma, mean, rstd = ctx.saved_tensors
        dx, dgamma, dbeta = layer_norm_bwd(x2d, gamma, mean, rstd, dy)
        return dx, dgamma, dbeta, None


def _rows_cols(x, begin_norm_axis, scale, bias):
    """``(rows, cols, gamma, beta)`` of the reference's flattening: rows
    over dims ``[:begin_norm_axis]``, cols over the rest, scale and bias
    flat over cols (ones and zeros when absent)."""
    rows = 1
    for d in x.shape[:begin_norm_axis]:
        rows *= d
    cols = 1
    for d in x.shape[begin_norm_axis:]:
        cols *= d
    gamma = (scale.reshape(cols) if scale is not None
             else torch.ones(cols, dtype=x.dtype, device=x.device))
    beta = (bias.reshape(cols) if bias is not None
            else torch.zeros(cols, dtype=x.dtype, device=x.device))
    return rows, cols, gamma, beta


def layer_norm_fused(x, scale=None, bias=None, begin_norm_axis=1,
                     epsilon=1e-5):
    """Layer norm over dims ``[begin_norm_axis:]``; scale/bias flat over
    those dims (the reference ``layer_norm_fused`` contract).
    Differentiable."""
    rows, cols, gamma, beta = _rows_cols(x, begin_norm_axis, scale, bias)
    y = LayerNormFunction.apply(x.reshape(rows, cols).contiguous(), gamma,
                                beta, epsilon)
    return y.reshape(x.shape)


# ---- K8: fused residual add + layer norm ---------------------------------

def add_layer_norm_plain(x2d, h2d, gamma, beta, epsilon):
    """The plain version of K8: ``(y, mean, rstd)`` of ``ln(x + h)``, the
    sum formed in f32 and never rounded (as the Pallas kernel keeps it),
    y in x's dtype, mean/rstd ``[R, 1]`` f32."""
    y, m, r = layer_norm_plain(x2d.float() + h2d.float(), gamma, beta,
                               epsilon)
    return y.to(x2d.dtype), m, r


def _add_layer_norm_cuda(x2d, h2d, gamma, beta, epsilon):
    """K8's op on CUDA tensors: one launch. x and
    h share one dtype (f32 or bf16), and so do scale and bias (f32 or
    bf16, either beside either row type: the bf16 policy's Transformer
    normalizes f32 rows with bf16 parameters); the rows must fit one
    block's shared memory (8 rows of C f32 sums, C padded to 256)."""
    types = (torch.float32, torch.bfloat16)
    code = core.dtype_code(x2d, types)
    pcode = core.dtype_code(gamma, types)
    if h2d.dtype != x2d.dtype:
        raise TypeError(f"add_layer_norm kernel: h is {h2d.dtype}, x is "
                        f"{x2d.dtype} (the sum x + h takes one row type)")
    if beta.dtype != gamma.dtype:
        raise TypeError(f"add_layer_norm kernel: bias is {beta.dtype}, "
                        f"scale is {gamma.dtype}")
    core.require_contiguous(x=x2d, h=h2d, gamma=gamma, beta=beta)
    r_, c_ = x2d.shape
    if h2d.shape != x2d.shape:
        raise ValueError(f"add_layer_norm kernel: h {tuple(h2d.shape)} is "
                         f"not x's {tuple(x2d.shape)}")
    if gamma.shape != (c_,) or beta.shape != (c_,):
        raise ValueError(f"scale/bias must be [{c_}]")
    smem = core.library().ptt_add_layer_norm_smem_bytes(c_)
    if smem > core.MAX_SMEM:
        raise ValueError(f"add_layer_norm kernel: C={c_} needs {smem} bytes "
                         f"of shared memory (max {core.MAX_SMEM})")
    y = torch.empty_like(x2d)
    mean = torch.empty((r_, 1), dtype=torch.float32, device=x2d.device)
    rstd = torch.empty((r_, 1), dtype=torch.float32, device=x2d.device)
    if r_ == 0 or c_ == 0:
        return y, mean, rstd
    KERNEL_ADD(code, pcode, core.ptr(x2d), core.ptr(h2d), core.ptr(gamma),
               core.ptr(beta), core.ptr(y), core.ptr(mean), core.ptr(rstd),
               r_, c_, float(epsilon), core.stream(x2d))
    return y, mean, rstd


ADD_LAYER_NORM_OP = core.define_op(
    KERNEL_ADD, "(Tensor x, Tensor h, Tensor gamma, Tensor beta, "
    "float epsilon) -> (Tensor, Tensor, Tensor)", _add_layer_norm_cuda,
    lambda x2d, h2d, gamma, beta, epsilon: _stats_like(x2d))


def add_layer_norm_kernel(x2d, h2d, gamma, beta, epsilon):
    """K8 on CUDA tensors, through its op; same outputs as the plain
    version."""
    return ADD_LAYER_NORM_OP(x2d, h2d, gamma, beta, float(epsilon))


def add_layer_norm_rows(x2d, h2d, gamma, beta, epsilon=1e-5):
    """``(y, mean, rstd)`` of ``ln(x + h)`` over the rows: K8 on CUDA
    tensors, the plain version on CPU tensors. Not differentiable; see
    :class:`AddLayerNormFunction`."""
    if core.on_card(x2d, h2d, gamma, beta):
        return add_layer_norm_kernel(x2d, h2d, gamma, beta, epsilon)
    return add_layer_norm_plain(x2d, h2d, gamma, beta, epsilon)


class AddLayerNormFunction(torch.autograd.Function):
    """``ln(x + h)`` over the rows as one differentiable op (the
    reference's ``_add_layer_norm_rows`` custom_vjp): K8 forward on CUDA
    tensors, the plain forward on CPU tensors. The backward is the
    reference's ``_aln_bwd``: the sum recomputed in f32, ``ds`` from the
    saved statistics, returned in x's dtype and in h's dtype."""

    @staticmethod
    def forward(ctx, x2d, h2d, gamma, beta, epsilon):
        y, mean, rstd = add_layer_norm_rows(x2d, h2d, gamma, beta, epsilon)
        ctx.save_for_backward(x2d, h2d, gamma, mean, rstd)
        return y

    @staticmethod
    def backward(ctx, dy):
        x2d, h2d, gamma, mean, rstd = ctx.saved_tensors
        ds, dgamma, dbeta = layer_norm_bwd(x2d.float() + h2d.float(), gamma,
                                           mean, rstd, dy)
        return ds.to(x2d.dtype), ds.to(h2d.dtype), dgamma, dbeta, None


def add_layer_norm_fused(x, h, scale=None, bias=None, begin_norm_axis=1,
                         epsilon=1e-5):
    """Fused ``ln(x + h)`` over dims ``[begin_norm_axis:]`` (the
    reference's ``add_layer_norm_fused`` contract): the residual add and
    the layer norm in one pass over device memory on the card.
    Differentiable."""
    rows, cols, gamma, beta = _rows_cols(x, begin_norm_axis, scale, bias)
    y = AddLayerNormFunction.apply(x.reshape(rows, cols).contiguous(),
                                   h.reshape(rows, cols).contiguous(), gamma,
                                   beta, epsilon)
    return y.reshape(x.shape)
