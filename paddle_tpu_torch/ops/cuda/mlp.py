"""K4: fused feed-forward ``gelu(x @ w1 + b1) @ w2 + b2`` — the CUDA
kernel, its plain PyTorch version, and the differentiable op around them.

Replaces ``paddle_tpu/ops/pallas/mlp.py:51 _mlp_kernel`` (launcher
``_mlp_pallas`` :92, entry ``fused_mlp`` :201); no gate. The backward is
the reference's ``_mlp_core_bwd`` (:184): the VJP of the plain
composition, recomputing ``h = x @ w1 + b1`` (its products go to
``torch.matmul``, as the reference leaves them to XLA).
Source: ``paddle_tpu_torch/csrc/mlp.cu`` (its header says why).

Two routes, chosen by :func:`mlp_route`, a rule on the storage type and
the widths:

* ``"tc"`` — bf16 with H, I and Hout multiples of 8 (the training paths):
  two tensor-core passes on the shared TMA + wgmma mainloop
  (``csrc/gemm.cuh``), ``a = bf16(gelu(x @ w1 + b1))`` into an ``[R, I]``
  scratch that lives only for the call, then ``a @ w2 + b2``; tile widths
  from :func:`gemm_plan`. Bound by operations.
* ``"simt"`` — f32 and every other shape (serving, the crosschecks): the
  CUDA cores in full f32; the I axis is split across blocks as well as
  the rows (:func:`split_plan`), so that decode's 8 rows fill the card,
  and the ``[R, I]`` activation never reaches device memory. Bound by
  bytes at decode. Gelu is the exact erf form
  (``paddle_tpu/ops/pallas/mlp.py:43``) on both routes.

A CUDA launch that fails raises; no route gives way to another. On the
card the kernel is reached through its op,
``torch.ops.paddle_tpu_torch.mlp`` (``core.define_op``), over ``[R, H]``
rows; the route plans (which read the SM count), the tc route's
``[R, I]`` scratch and the simt route's split partials are made inside
it. The gradient stays with :class:`MLPFunction` around the op.
"""

import torch

from paddle_tpu_torch.ops.activations import gelu
from paddle_tpu_torch.ops.cuda import core

KERNEL = core.register(
    "mlp", "ptt_mlp",
    [core.I32] + [core.VP] * 7 + [core.I32] * 6 + [core.VP],
    replaces="paddle_tpu/ops/pallas/mlp.py:51",
    source="paddle_tpu_torch/csrc/mlp.cu",
    routes={"tc": ("ptt_mlp_tc", [core.VP] * 7 + [core.I32] * 8
                   + [core.VP])})

#: the simt route: rows per tile and intermediate columns per chunk
BLOCK_ROWS, BLOCK_I = 16, 32
#: the tc route (csrc/gemm.cuh): rows per tile, the tile widths it has
TC_ROWS, TC_WIDTHS = 128, (256, 192, 128)
#: the share of the waves' SM slots a tile width must keep busy
TC_BUSY = 7 / 8


def mlp_plain(x, w1, b1, w2, b2):
    """The plain version, the reference's ``_mlp_unfused`` (Linear
    matmul + bias in the input dtype, then exact gelu)."""
    return gelu(x @ w1 + b1) @ w2 + b2


def split_plan(rows, inter, num_sms):
    """``(splits, chunks_per_split)`` of the I axis: enough blocks for two
    per SM when the row tiles alone are too few, each split a whole
    number of 32-column chunks."""
    row_tiles = -(-rows // BLOCK_ROWS)
    n_chunks = -(-inter // BLOCK_I)
    want = max(1, -(-2 * num_sms // row_tiles))
    per = -(-n_chunks // min(n_chunks, want))
    return -(-n_chunks // per), per


def mlp_route(dtype, hidden, inter, hout):
    """``"tc"`` for bf16 with H, I and Hout all multiples of 8 (a TMA row
    is a whole number of 16-byte units), else ``"simt"``."""
    if dtype == torch.bfloat16 and not (hidden % 8 or inter % 8
                                        or hout % 8):
        return "tc"
    return "simt"


def gemm_plan(rows, cols, sms):
    """One tc pass's ``(width, tiles, grid)`` for an ``[rows, cols]``
    output: 128-row tiles, ``width`` columns each, one tile per work item,
    ``grid`` persistent blocks (at most one per SM). The width is the
    widest of :data:`TC_WIDTHS` whose tiles keep at least
    :data:`TC_BUSY` of the waves' SM slots busy (so two waves end at least
    3/4 full), else the one that keeps most busy."""
    best = None
    for width in TC_WIDTHS:
        tiles = -(-rows // TC_ROWS) * -(-cols // width)
        busy = core.wave_busy(tiles, sms)
        if busy >= TC_BUSY:
            return width, tiles, min(tiles, sms)
        if best is None or busy > best[0]:
            best = (busy, width, tiles)
    return best[1], best[2], min(best[2], sms)


def _mlp_tc(x2, w1, b1, w2, b2, out):
    rows, hidden = x2.shape
    inter, hout = w1.shape[1], w2.shape[1]
    # TMA reads 16-byte aligned rows and the epilogue bias pairs: an
    # operand that does not start on 16 bytes is copied (a fresh
    # allocation does)
    x2, w1, b1, w2, b2 = (t if t.data_ptr() % 16 == 0 else t.clone()
                          for t in (x2, w1, b1, w2, b2))
    sms = torch.cuda.get_device_properties(x2.device).multi_processor_count
    width1, _, grid1 = gemm_plan(rows, inter, sms)
    width2, _, grid2 = gemm_plan(rows, hout, sms)
    act = torch.empty((rows, inter), dtype=torch.bfloat16, device=x2.device)
    KERNEL(core.ptr(x2), core.ptr(w1), core.ptr(b1), core.ptr(w2),
           core.ptr(b2), core.ptr(act), core.ptr(out), rows, hidden, inter,
           hout, width1, grid1, width2, grid2, core.stream(x2), route="tc")
    del act                  # enqueued: stream order protects the scratch
    return out


def _mlp_cuda(x2, w1, b1, w2, b2):
    """K4's op on CUDA tensors: the launch on the route :func:`mlp_route`
    picks."""
    code = core.dtype_code(x2, (torch.float32, torch.bfloat16))
    for name, t in (("w1", w1), ("b1", b1), ("w2", w2), ("b2", b2)):
        if t.dtype != x2.dtype:
            raise TypeError(f"mlp kernel: {name} is {t.dtype}, x is "
                            f"{x2.dtype}")
    core.require_contiguous(x=x2, w1=w1, b1=b1, w2=w2, b2=b2)
    rows, hidden = x2.shape
    inter, hout = w1.shape[1], w2.shape[1]
    if (w1.shape[0] != hidden or w2.shape[0] != inter
            or b1.shape != (inter,) or b2.shape != (hout,)):
        raise ValueError("mlp kernel: shapes do not chain: x "
                         f"{tuple(x2.shape)} w1 {tuple(w1.shape)} b1 "
                         f"{tuple(b1.shape)} w2 {tuple(w2.shape)} b2 "
                         f"{tuple(b2.shape)}")
    out = torch.empty((rows, hout), dtype=x2.dtype, device=x2.device)
    if mlp_route(x2.dtype, hidden, inter, hout) == "tc":
        return _mlp_tc(x2, w1, b1, w2, b2, out) if rows else out
    smem = core.library().ptt_mlp_smem_bytes(hidden, hout)
    if smem > core.MAX_SMEM:
        raise ValueError(f"mlp kernel: H={hidden}, Hout={hout} need {smem} "
                         f"bytes of shared memory (max {core.MAX_SMEM})")
    if rows == 0:
        return out
    sms = torch.cuda.get_device_properties(x2.device).multi_processor_count
    nsplit, per = split_plan(rows, inter, sms)
    part = torch.empty((nsplit, rows, hout), dtype=torch.float32,
                       device=x2.device)
    KERNEL(code, core.ptr(x2), core.ptr(w1), core.ptr(b1), core.ptr(w2),
           core.ptr(b2), core.ptr(out), core.ptr(part), rows, hidden, inter,
           hout, nsplit, per, core.stream(x2))
    return out


MLP_OP = core.define_op(
    KERNEL, "(Tensor x, Tensor w1, Tensor b1, Tensor w2, Tensor b2) -> "
    "Tensor", _mlp_cuda,
    lambda x2, w1, b1, w2, b2: x2.new_empty((x2.shape[0], w2.shape[1])))


def mlp_kernel(x2, w1, b1, w2, b2):
    """K4 on CUDA tensors, through its op. x2 ``[R, H]``, w1 ``[H, I]``,
    b1 ``[I]``, w2 ``[I, Hout]``, b2 ``[Hout]``, all of one dtype ->
    ``[R, Hout]``."""
    return MLP_OP(x2, w1, b1, w2, b2)


def mlp_bwd(x, w1, b1, w2, g):
    """The VJP of the plain composition for the output cotangent ``g``:
    ``(dx, dw1, db1, dw2, db2)``. Recomputes ``h = x @ w1 + b1`` and its
    gelu, then ``dW2 = a^T g``, ``da = g W2^T``, ``dh = da * gelu'(h)``,
    ``dW1 = x^T dh``, ``dx = dh W1^T``."""
    x2 = x.reshape(-1, x.shape[-1])
    g2 = g.reshape(-1, g.shape[-1])
    h = x2 @ w1 + b1
    dh = torch.ops.aten.gelu_backward(g2 @ w2.T, h, approximate="none")
    return ((dh @ w1.T).reshape(x.shape), x2.T @ dh, dh.sum(dim=0),
            gelu(h).T @ g2, g2.sum(dim=0))


class MLPFunction(torch.autograd.Function):
    """The fused MLP as one differentiable op (the reference's
    ``_mlp_core`` custom_vjp): K4 forward on CUDA tensors, the plain
    forward on CPU tensors (on the original leading shape, as the
    reference's unfused path), and :func:`mlp_bwd` on both."""

    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2):
        ctx.save_for_backward(x, w1, b1, w2)
        if not core.on_card(x, w1, b1, w2, b2):
            return mlp_plain(x, w1, b1, w2, b2)
        lead = x.shape[:-1]
        out = mlp_kernel(x.reshape(-1, x.shape[-1]).contiguous(), w1, b1,
                         w2, b2)
        return out.reshape(*lead, w2.shape[1])

    @staticmethod
    def backward(ctx, g):
        return mlp_bwd(*ctx.saved_tensors, g)


def fused_mlp(x, w1, b1, w2, b2):
    """``gelu(x @ w1 + b1) @ w2 + b2`` over the last axis of ``x``: K4 on
    CUDA tensors (on the route :func:`mlp_route` picks), the plain
    version on CPU tensors. Differentiable."""
    return MLPFunction.apply(x, w1, b1, w2, b2)
