"""K4: fused feed-forward ``gelu(x @ w1 + b1) @ w2 + b2`` — the CUDA
kernel, its plain PyTorch version, and the differentiable op around them.

Replaces ``paddle_tpu/ops/pallas/mlp.py:51 _mlp_kernel`` (launcher
``_mlp_pallas`` :92, entry ``fused_mlp`` :201); no gate. The backward is
the reference's ``_mlp_core_bwd`` (:184): the VJP of the plain
composition, recomputing ``h = x @ w1 + b1`` (its products go to
``torch.matmul``, as the reference leaves them to XLA).
Source: ``paddle_tpu_torch/csrc/mlp.cu`` (its header says why).

Three routes, chosen by :func:`mlp_route`, a rule on the storage type,
the widths and the rows:

* ``"tc"`` — bf16 with H, I and Hout multiples of 8 (the training paths):
  two tensor-core passes on the shared TMA + wgmma mainloop
  (``csrc/gemm.cuh``), ``a = bf16(gelu(x @ w1 + b1))`` into an ``[R, I]``
  scratch that lives only for the call, then ``a @ w2 + b2``; tile widths
  from :func:`gemm_plan`. Bound by operations.
* ``"split"`` — f32 at most :data:`SPLIT_ROWS` rows (serving's decode,
  draft and verify calls), and bf16 at other widths: one pass on the CUDA
  cores in full f32 (``csrc/mlp_simt.cu``). The I axis is cut into about
  one block per SM (:func:`split_plan`); each block streams its slices of
  W1 and W2 once, keeps its activation in shared memory 32 columns at a
  time and writes an f32 partial of the output, which a second kernel
  sums in a fixed order with b2. Bound by bytes: the weights are read
  once.
* ``"gemm"`` — f32 at more rows (prefill chunks, generate's prefill, the
  f32 crosschecks): two register-blocked SIMT GEMM passes in full f32
  (``csrc/mlp_simt.cu``), ``act = gelu(x @ w1 + b1)`` into an f32
  ``[R, I]`` scratch, then ``act @ w2 + b2``, pass 2 split over I where
  its tiles alone would leave SMs idle (:func:`simt_gemm_plan`), the
  partials summed in a fixed order. Bound by operations.

Gelu is the exact erf form (``paddle_tpu/ops/pallas/mlp.py:43``) on every
route; no route uses TF32.

A CUDA launch that fails raises; no route gives way to another. On the
card the kernel is reached through its op,
``torch.ops.paddle_tpu_torch.mlp`` (``core.define_op``), over ``[R, H]``
rows; the route plans (which read the SM count) and every route's
scratch (the ``[R, I]`` activation, the partials) are made inside it. The gradient stays with :class:`MLPFunction` around the op.
"""

import torch

from paddle_tpu_torch.ops.activations import gelu
from paddle_tpu_torch.ops.cuda import core

KERNEL = core.register(
    "mlp", "ptt_mlp_split",
    [core.I32] + [core.VP] * 7 + [core.I32] * 6 + [core.VP],
    replaces="paddle_tpu/ops/pallas/mlp.py:51",
    source="paddle_tpu_torch/csrc/mlp_simt.cu", route="split",
    routes={"gemm": ("ptt_mlp_gemm", [core.VP] * 8 + [core.I32] * 7
                     + [core.VP]),
            "tc": ("ptt_mlp_tc", [core.VP] * 7 + [core.I32] * 8
                   + [core.VP])},
    route_sources={"tc": "paddle_tpu_torch/csrc/mlp.cu"})

#: the split route: the most f32 rows it takes, its row tiles, the I
#: columns of a unit of a slice, and the columns of a block's activation
#: at a time (the widest slice at one row tile)
SPLIT_ROWS, SPLIT_TILES, SPLIT_UNIT, SPLIT_WIDEST = 32, (8, 16, 32), 8, 32
#: the gemm route (csrc/mlp_simt.cu): the tile rows it has, its tile
#: columns, k per stage, the most splits of pass 2's depth
SIMT_ROWS, SIMT_COLS, SIMT_BK, SIMT_MAX_SPLITS = (128, 64), 96, 32, 8
#: the tc route (csrc/gemm.cuh): rows per tile, the tile widths it has
TC_ROWS, TC_WIDTHS = 128, (256, 192, 128)
#: the share of the waves' SM slots a tile width must keep busy
TC_BUSY = 7 / 8


def mlp_plain(x, w1, b1, w2, b2):
    """The plain version, the reference's ``_mlp_unfused`` (Linear
    matmul + bias in the input dtype, then exact gelu)."""
    return gelu(x @ w1 + b1) @ w2 + b2


def split_plan(rows, inter, sms):
    """The split route's ``(row tile, splits)``: the row tile is the
    smallest of :data:`SPLIT_TILES` that holds the rows (the largest, in
    a grid of row tiles, past it); the I axis's units of
    :data:`SPLIT_UNIT` columns are cut into the fewest slices whose
    blocks (slices x row tiles) number at least one an SM and at least
    one for each :data:`SPLIT_WIDEST` columns of I, and never more
    slices than units. At one row tile (serving's 8 and 32 rows) that is
    one slice per SM, none wider than SPLIT_WIDEST; at many row tiles
    (bf16 at widths the tensor cores cannot take) it falls to one, so
    the ``[splits, rows, Hout]`` partials stay near the output's size,
    and a block walks its wider slice SPLIT_WIDEST columns at a time."""
    tile = next((t for t in SPLIT_TILES if rows <= t), SPLIT_TILES[-1])
    row_tiles = -(-rows // tile)
    units = -(-inter // SPLIT_UNIT)
    return tile, min(units, max(
        -(-sms // row_tiles),
        -(-units // (SPLIT_WIDEST // SPLIT_UNIT * row_tiles))))


def split_slices(inter, splits):
    """``[(i0, i1)]``: the I columns of each split, as the kernel cuts
    them (split s takes units ``s * units // splits`` up to the next
    split's first)."""
    units = -(-inter // SPLIT_UNIT)
    return [(s * units // splits * SPLIT_UNIT,
             min(inter, (s + 1) * units // splits * SPLIT_UNIT))
            for s in range(splits)]


def simt_issue_share(bm):
    """The share of a gemm-route thread's issued instructions that are
    FMAs: per four k, ``4 * (bm / 16) * 6`` FMAs against ``bm / 16``
    16-byte reads of A and twelve 8-byte reads of B."""
    fmas = 4 * (bm // 16) * (SIMT_COLS // 16)
    return fmas / (fmas + bm // 16 + 4 * (SIMT_COLS // 32))


def simt_gemm_plan(rows, cols, depth, slots, split=False):
    """One gemm-route pass's ``(tile rows, splits, blocks)`` for an
    ``[rows, cols]`` output over ``depth``: of the tile rows in
    :data:`SIMT_ROWS` and (``split``: pass 2) 1 to
    :data:`SIMT_MAX_SPLITS` splits of the depth's k tiles, the one whose
    waves (over ``slots[bm]``, the card's resident block slots at that
    tile height: ``core.resident_slots``) times a block's rows and k
    tiles, over :func:`simt_issue_share`, are least; ties keep the
    larger tile and the fewer splits."""
    kts = -(-depth // SIMT_BK)
    best = None
    for bm in SIMT_ROWS:
        tiles = -(-rows // bm) * -(-cols // SIMT_COLS)
        for splits in range(1, (min(SIMT_MAX_SPLITS, kts) if split else 1)
                            + 1):
            blocks = tiles * splits
            cost = (-(-blocks // slots[bm]) * bm * -(-kts // splits)
                    / simt_issue_share(bm))
            if best is None or cost < best[0]:
                best = (cost, bm, splits, blocks)
    return best[1:]


def simt_k_ranges(depth, splits):
    """``[(k0, k1)]``: the k tiles of each split of a gemm-route pass, as
    the kernel cuts them; the partials are summed in this order."""
    kts = -(-depth // SIMT_BK)
    return [(z * kts // splits, (z + 1) * kts // splits)
            for z in range(splits)]


def mlp_route(dtype, hidden, inter, hout, rows):
    """``"tc"`` for bf16 with H, I and Hout all multiples of 8 (a TMA row
    is a whole number of 16-byte units), ``"split"`` for other bf16 and
    for f32 at most :data:`SPLIT_ROWS` rows, ``"gemm"`` for f32 at more
    rows."""
    if dtype == torch.bfloat16:
        return "split" if hidden % 8 or inter % 8 or hout % 8 else "tc"
    return "split" if rows <= SPLIT_ROWS else "gemm"


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
    """K4's op on CUDA tensors: one launch on the route :func:`mlp_route`
    picks (the routes' second kernels, the merge and the split-K sum,
    are part of it)."""
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
    route = mlp_route(x2.dtype, hidden, inter, hout, rows)
    if rows == 0:
        return out
    if route == "tc":
        return _mlp_tc(x2, w1, b1, w2, b2, out)
    f32 = torch.float32
    if route == "gemm":
        slots = {bm: core.resident_slots("ptt_mlp_gemm_resident", bm)
                 for bm in SIMT_ROWS}
        bm1, _, _ = simt_gemm_plan(rows, inter, hidden, slots)
        bm2, splits, _ = simt_gemm_plan(rows, hout, inter, slots, split=True)
        act = torch.empty((rows, inter), dtype=f32, device=x2.device)
        part = (torch.empty((splits, rows, hout), dtype=f32,
                            device=x2.device) if splits > 1 else None)
        KERNEL(core.ptr(x2), core.ptr(w1), core.ptr(b1), core.ptr(w2),
               core.ptr(b2), core.ptr(act), core.ptr(part), core.ptr(out),
               rows, hidden, inter, hout, bm1, bm2, splits, core.stream(x2),
               route="gemm")
        del act, part        # enqueued: stream order protects the scratch
        return out
    sms = torch.cuda.get_device_properties(x2.device).multi_processor_count
    tile, splits = split_plan(rows, inter, sms)
    part = torch.empty((splits, rows, hout), dtype=f32, device=x2.device)
    KERNEL(code, core.ptr(x2), core.ptr(w1), core.ptr(b1), core.ptr(w2),
           core.ptr(b2), core.ptr(part), core.ptr(out), rows, hidden, inter,
           hout, tile, splits, core.stream(x2), route="split")
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
