"""K5 and K6: fused vocab cross-entropy — the CUDA kernels and their plain
PyTorch versions.

K5 replaces ``paddle_tpu/ops/pallas/xent.py:49 _xent_fwd_kernel``
(launcher ``xent_stats_pallas`` :99): the per-row ``(m, s, picked,
sum_logits)`` of the logits ``h @ W^T + b`` in f32, an online logsumexp
over the vocab. K6 replaces ``:178 _xent_bwd_dh_kernel`` and ``:200
_xent_bwd_dwb_kernel`` (launcher ``xent_bwd_pallas`` :227): dh ``[N, H]``,
dw ``[V, H]`` and db ``[V]`` in f32, recomputing the smoothed-CE dlogits
``(p - sn - (sp - sn) * onehot) * g`` tile by tile from the saved logz.
Source: ``paddle_tpu_torch/csrc/xent.cu``. The ``[N, V]`` logits never
reach device memory. Weights are in the tied ``[V, H]`` ("vh") layout;
h and W share one storage type (f32 or bf16); the bias is f32.

K5 takes one of three routes by :func:`stats_route`: bf16 with ``H % 8 ==
0`` runs on the tensor cores (``"tc"``: the shared TMA + wgmma mainloop
of ``csrc/gemm.cuh`` with an online-statistics epilogue, split as
:func:`stats_tc_plan` says; no H limit), f32 with ``H % 4 == 0`` on the
same mainloop with f32-accurate 3xTF32 products (``"tf32x3"``: each
operand split into two TF32 parts, three tensor-core products; the same
plan), everything else on the CUDA cores (``"simt"``, ``H <= 1744``,
shared memory). A launch that fails raises.

K6 takes one of three routes by :func:`bwd_route`: bf16 runs on the
tensor cores (``"tc"``: wgmma fed by TMA, :func:`tc_plan`), f32 with ``H
% 4 == 0`` on 3xTF32 wgmma (``"tf32x3"``, :func:`x3_plan`: the blocks of
one resident tile, a chunk of H each, form a cluster that computes the
logits once; ``H <= 2048``), any other f32 on the CUDA cores (``"simt"``,
:func:`simt_plan`). A launch that fails
raises; no route falls back to another. The limits are shared memory:
each plan raises for a hidden size whose tiles do not fit in
:data:`core.MAX_SMEM`, and the TMA routes need H to be a whole number of
16-byte units (``H % 8 == 0`` in bf16, ``H % 4 == 0`` in f32).

On the card the kernels are reached through their ops
(``core.define_op``): ``torch.ops.paddle_tpu_torch.xent_stats`` returns
the four statistics as the rows of one ``[4, N]`` f32 tensor (the
kernel writes them into one buffer, and a custom op's outputs may not
alias one another), which :func:`xent_stats_kernel` splits;
``.xent_bwd_dh`` returns dh and ``.xent_bwd_dwb`` ``(dw, db)``. The
launch plans (which read the SM count) and the split partials are made
inside the ops.

The plain versions are the reference's chunked XLA formulation:
``_xent_stats_parts`` (``paddle_tpu/ops/fused.py:75``) and the chunk loop
of ``_xent_bwd_impl`` (:159-186), over vocab chunks of :data:`CHUNK`.
Labels outside ``[0, V)`` never hit, in both.
"""

import torch

from paddle_tpu_torch.ops.cuda import core

_SRC = "paddle_tpu_torch/csrc/xent.cu"
KERNEL_STATS = core.register(
    "xent_stats", "ptt_xent_stats",
    [core.I32] + [core.VP] * 6 + [core.I32] * 5 + [core.VP],
    replaces="paddle_tpu/ops/pallas/xent.py:49", source=_SRC,
    routes={r: (sym, [core.VP] * 6 + [core.I32] * 6 + [core.VP])
            for r, sym in (("tc", "ptt_xent_stats_tc"),
                           ("tf32x3", "ptt_xent_stats_tf32x3"))})
_DH_ARGS = ([core.I32] + [core.VP] * 8 + [core.I32] * 7
            + [core.F32_ARG, core.F32_ARG, core.VP])
_DWB_ARGS = ([core.I32] + [core.VP] * 10 + [core.I32] * 7
             + [core.F32_ARG, core.F32_ARG, core.VP])
# K6's C entry chooses between its SIMT and bf16 kernels by storage type;
# the "tc" route names the same entry, so that each route counts its own
KERNEL_DH = core.register(
    "xent_bwd_dh", "ptt_xent_bwd_dh", _DH_ARGS,
    replaces="paddle_tpu/ops/pallas/xent.py:178", source=_SRC,
    routes={"tc": ("ptt_xent_bwd_dh", _DH_ARGS),
            "tf32x3": ("ptt_xent_bwd_dh_tf32x3", _DH_ARGS)})
KERNEL_DWB = core.register(
    "xent_bwd_dwb", "ptt_xent_bwd_dwb", _DWB_ARGS,
    replaces="paddle_tpu/ops/pallas/xent.py:200", source=_SRC,
    routes={"tc": ("ptt_xent_bwd_dwb", _DWB_ARGS),
            "tf32x3": ("ptt_xent_bwd_dwb_tf32x3", _DWB_ARGS)})

#: vocab chunk of the plain versions (the reference's xent_chunk flag)
CHUNK = 8192
#: f32 blocks (K5, and K6's f32 route): resident rows per block,
#: streamed rows per tile, and output columns per block (12 accumulator
#: columns of 64 per thread)
RES_ROWS, STREAM_ROWS, SIMT_COLS = 32, 64, 768
#: K6's bf16 route: resident rows per block, streamed rows per tile and
#: columns per TMA box, 64-column output slots per warpgroup at most, and
#: the ring's largest stage count
TC_ROWS, TC_BOX, TC_MAX_SLOTS, TC_MAX_STAGES = 64, 64, 4, 8
#: K6 (every route): the most splits of the streamed axis
MAX_SPLITS = 8
#: K5's bf16 route (csrc/gemm.cuh): rows and vocab columns per tile, the
#: most vocab splits, and the share of the waves' SM slots to keep busy
STATS_TC_ROWS, STATS_TC_WIDTH, STATS_TC_MAX_SPLITS = 128, 256, 16
STATS_TC_BUSY = 7 / 8
_BOX_BYTES = TC_BOX * TC_BOX * 2          # a TMA box; a ring stage holds 2
#: K6's f32 route on 3xTF32 (csrc/xent.cu x3): resident rows per block (64
#: a consumer warpgroup), streamed rows per tile, output columns per
#: block (a chunk of H) and ring stages
X3_ROWS, X3_STREAM, X3_COLS, X3_STAGES = 128, 64, 256, 2
#: the most chunks of H (blocks of a cluster) K6's tf32x3 route takes
X3_MAX_CLUSTER = 8


def _chunk_logits(h, w, b, c0, c1):
    """f32 logits of vocab columns ``[c0, c1)``."""
    logits = h.float() @ w[c0:c1].float().T
    if b is not None:
        logits = logits + b[c0:c1].float()[None, :]
    return logits


def _hit(labels, c0, c1):
    """``[N, c1 - c0]`` bool: column ``c0 + j`` is row i's label."""
    col = torch.arange(c0, c1, device=labels.device)
    return col[None, :] == labels.long()[:, None]


def xent_stats_plain(h, w, b, labels, chunk=CHUNK):
    """``(m, s, picked, sum_logits)``, each ``[N]`` f32 — the reference's
    ``_xent_stats_parts`` over vocab chunks."""
    n, v = h.shape[0], w.shape[0]
    m = torch.full((n,), float("-inf"), dtype=torch.float32, device=h.device)
    s = torch.zeros(n, dtype=torch.float32, device=h.device)
    picked = torch.zeros_like(s)
    sl = torch.zeros_like(s)
    for c0 in range(0, v, chunk):
        c1 = min(c0 + chunk, v)
        logits = _chunk_logits(h, w, b, c0, c1)
        m_new = torch.maximum(m, logits.amax(dim=1))
        s = s * torch.exp(m - m_new) + torch.exp(
            logits - m_new[:, None]).sum(dim=1)
        m = m_new
        picked = picked + torch.where(_hit(labels, c0, c1), logits,
                                      torch.zeros_like(logits)).sum(dim=1)
        sl = sl + logits.sum(dim=1)
    return m, s, picked, sl


def _check(h, w, b, labels, what):
    code = core.dtype_code(h, (torch.float32, torch.bfloat16))
    if w.dtype != h.dtype:
        raise TypeError(f"{what}: weight is {w.dtype}, hidden is {h.dtype}")
    n, hid = h.shape
    v = w.shape[0]
    if w.shape != (v, hid):
        raise ValueError(f"{what}: weight {tuple(w.shape)} is not [V, "
                         f"{hid}] (the vh layout)")
    if labels.shape != (n,):
        raise ValueError(f"{what}: labels must be [{n}]")
    if b is not None and (b.shape != (v,) or b.dtype != torch.float32):
        raise ValueError(f"{what}: bias must be [{v}] f32")
    core.require_contiguous(h=h, w=w, b=b)
    return code, n, v, hid


def stats_smem(hid):
    """Shared memory of a K5 block (``csrc/xent.cu stats_smem``)."""
    return 4 * (RES_ROWS * (hid + 1) + STREAM_ROWS * 33)


def simt_smem(hid):
    """Shared memory of an f32 K6 block (``csrc/xent.cu bwd_smem``)."""
    chunk = max(8 * min(hid, SIMT_COLS), STREAM_ROWS * 33)
    return 4 * (RES_ROWS * (hid + 1) + RES_ROWS * 65 + chunk)


def _fits(what, hid, smem):
    if smem > core.MAX_SMEM:
        raise ValueError(f"{what}: hidden size {hid} needs {smem} bytes of "
                         f"shared memory per block > {core.MAX_SMEM}")


def tc_smem(hid, stages):
    """Shared memory of a bf16 K6 block (``csrc/xent.cu tc::smem_bytes``):
    the resident tile (H/64 boxes), the ring (two boxes a stage), two gch
    tiles, the barriers, the db exchange and the stage table, plus 1 KB
    of alignment."""
    boxes = -(-hid // TC_BOX) + 2 * stages + 2
    return (1024 + boxes * _BOX_BYTES + (2 * stages + 1) * 8 + 4 * TC_ROWS
            + 16 * 8)


def x3_smem():
    """Shared memory of a 3xTF32 K6 block (``csrc/xent.cu x3::kSmem``):
    1 KB of alignment; the ring, each stage four boxes (R's two, X's one
    and its lo part); the staged ``[256, 64]`` X^T, hi and lo; the
    block's partial ``[128, 64]`` logits for its cluster; the per-column
    parameters of a tile; the barriers."""
    stage = 4 * _BOX_BYTES
    staged = 2 * X3_COLS * X3_STREAM * 4
    partial = X3_ROWS * X3_STREAM * 4
    return 1024 + X3_STAGES * stage + staged + partial \
        + 4 * X3_STREAM * 4 + (2 * X3_STAGES + 2) * 8


def wave_splits(units, tiles, sms):
    """``(splits, tiles_per_split)`` of a streamed axis of ``tiles`` tiles
    under ``units`` blocks of equal work, one block per SM (both K6
    routes): the fewest splits whose last wave is at least half full,
    else the fullest last wave within :data:`MAX_SPLITS`."""
    best = None
    for want in range(1, min(MAX_SPLITS, tiles) + 1):
        per = -(-tiles // want)
        splits = -(-tiles // per)
        blocks = units * splits
        fill = blocks / sms - (-(-blocks // sms) - 1)
        if fill >= 0.5:
            return splits, per
        if best is None or fill > best[0]:
            best = (fill, splits, per)
    return best[1], best[2]


def tc_plan(resident, streamed, hid, sms):
    """K6's bf16 launch plan (a pure function of the shape and the SM
    count): ``dict(chunks, slots, splits, per, stages, smem)``. Blocks are
    ``ceil(resident / 64) x chunks x splits``, one per SM. H is cut into
    the fewest chunks of at most 512 columns, each ``2 x slots`` boxes of
    64 (``csrc/xent.cu tc::slots_for``): two warpgroups of ``slots``
    64-column accumulators. Each streamed tile of 64 rows arrives as H/64
    boxes, two to a stage, through a ring of ``stages`` stages, which must
    hold the chunk's own boxes at once. Raises for a shape the kernel does
    not take."""
    what = "xent backward (bf16)"
    if hid % 8:
        raise ValueError(f"{what}: hidden size {hid} is not a multiple of 8 "
                         "(TMA rows are whole 16-byte units)")
    boxes = -(-hid // TC_BOX)
    chunks = -(-boxes // (2 * TC_MAX_SLOTS))
    slots = -(-(-(-boxes // chunks)) // 2)
    held = -(-min(boxes, 2 * slots) // 2)
    stages = min(TC_MAX_STAGES,
                 (core.MAX_SMEM - tc_smem(hid, 0)) // (2 * _BOX_BYTES + 16))
    if stages < held:
        _fits(what, hid, tc_smem(hid, held))
    tiles = max(1, -(-streamed // TC_BOX))
    splits, per = wave_splits(-(-resident // TC_ROWS) * chunks, tiles, sms)
    return dict(chunks=chunks, slots=slots, splits=splits, per=per,
                stages=stages, smem=tc_smem(hid, stages))


def x3_plan(resident, streamed, hid, sms):
    """K6's f32 plan on 3xTF32: ``dict(chunks, splits, per, stages,
    smem)``. Blocks are ``chunks x ceil(resident / 128) x splits``, one
    per SM; H is cut into chunks of 256 columns, the blocks of one
    resident tile and split (one a chunk) form a cluster that shares the
    logits; the streamed axis split as :func:`wave_splits` says. Raises
    for a shape the kernel does not take."""
    what = "xent backward (f32, tf32x3)"
    if hid % 4:
        raise ValueError(f"{what}: hidden size {hid} is not a multiple of 4 "
                         "(TMA rows are whole 16-byte units)")
    _fits(what, hid, x3_smem())
    chunks = -(-hid // X3_COLS)
    if chunks > X3_MAX_CLUSTER:
        raise ValueError(f"{what}: hidden size {hid} needs {chunks} chunks "
                         f"of {X3_COLS}, a cluster takes at most "
                         f"{X3_MAX_CLUSTER}")
    splits, per = wave_splits(-(-resident // X3_ROWS) * chunks,
                              max(1, -(-streamed // X3_STREAM)), sms)
    return dict(chunks=chunks, splits=splits, per=per, stages=X3_STAGES,
                smem=x3_smem())


def simt_plan(resident, streamed, hid, sms):
    """K6's f32 launch plan: ``dict(chunks, splits, per, smem)``; blocks
    are ``ceil(resident / 32) x splits x chunks`` of 768 columns each,
    one per SM (the register accumulator), split as :func:`wave_splits`
    says."""
    smem = simt_smem(hid)
    _fits("xent backward (f32)", hid, smem)
    chunks = -(-hid // SIMT_COLS)
    splits, per = wave_splits(-(-resident // RES_ROWS) * chunks,
                              -(-streamed // STREAM_ROWS), sms)
    return dict(chunks=chunks, splits=splits, per=per, smem=smem)


def _split_plan(resident, streamed, blocks_wanted):
    """K5's ``(splits, tiles_per_split)`` of the streamed axis: enough
    splits that ``resident tiles x splits`` reaches ``blocks_wanted``.
    Not :func:`wave_splits`: a K5 block has no accumulator to keep it to
    one per SM, and one block alone does not keep an SM busy, so K5 asks
    for several blocks per SM rather than whole waves of one."""
    res_tiles = -(-resident // RES_ROWS)
    tiles = -(-streamed // STREAM_ROWS)
    want = max(1, -(-blocks_wanted // res_tiles))
    per = -(-tiles // min(tiles, want))
    return -(-tiles // per), per


def stats_route(dtype, hid):
    """K5's route: ``"tc"`` for bf16 with ``H % 8 == 0`` and
    ``"tf32x3"`` for f32 with ``H % 4 == 0`` (whole 16-byte TMA rows),
    else ``"simt"``."""
    if dtype == torch.bfloat16 and hid % 8 == 0:
        return "tc"
    if dtype == torch.float32 and hid % 4 == 0:
        return "tf32x3"
    return "simt"


def bwd_route(dtype, hid):
    """K6's route: ``"tc"`` for bf16 (:func:`tc_plan` refuses ``H % 8 !=
    0``), ``"tf32x3"`` for f32 with ``H % 4 == 0``, else ``"simt"``."""
    if dtype == torch.bfloat16:
        return "tc"
    return "tf32x3" if hid % 4 == 0 else "simt"


def stats_tc_plan(n, v, sms):
    """K5's bf16 plan ``(splits, tiles_per_split, grid)``: the vocab's
    256-column tiles cut into the fewest splits whose ``128-row tiles x
    splits`` work items keep at least :data:`STATS_TC_BUSY` of the waves'
    SM slots busy (else the busiest within :data:`STATS_TC_MAX_SPLITS`),
    on ``grid`` persistent blocks (at most one per SM)."""
    row_tiles = -(-n // STATS_TC_ROWS)
    tiles = -(-v // STATS_TC_WIDTH)
    best = None
    for want in range(1, min(STATS_TC_MAX_SPLITS, tiles) + 1):
        per = -(-tiles // want)
        splits = -(-tiles // per)
        items = row_tiles * splits
        busy = core.wave_busy(items, sms)
        if busy >= STATS_TC_BUSY:
            return splits, per, min(items, sms)
        if best is None or busy > best[0]:
            best = (busy, splits, per, items)
    return best[1], best[2], min(best[3], sms)


def _sms(t):
    return torch.cuda.get_device_properties(t.device).multi_processor_count


def _stats_tc(h, w, b, lbl, out, n, v, hid, route):
    """K5 on the mainloop: ``route`` ``"tc"`` (bf16) or ``"tf32x3"``
    (f32), one plan for both."""
    # TMA reads 16-byte aligned rows: a misaligned operand is copied
    h, w = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (h, w))
    nsplit, per, grid = stats_tc_plan(n, v, _sms(h))
    part = (torch.empty((nsplit, 4, n), dtype=torch.float32,
                        device=h.device) if nsplit > 1 else None)
    KERNEL_STATS(core.ptr(h), core.ptr(w), core.ptr(b), core.ptr(lbl),
                 core.ptr(out), core.ptr(part), n, v, hid, nsplit, per, grid,
                 core.stream(h), route=route)
    return out


def _xent_stats_cuda(h, w, b, labels):
    """K5's op on CUDA tensors: one launch on the route
    :func:`stats_route` picks -> ``[4, N]`` f32."""
    code, n, v, hid = _check(h, w, b, labels, "xent_stats kernel")
    out = torch.empty((4, n), dtype=torch.float32, device=h.device)
    if n == 0 or v == 0:
        return out
    lbl = labels.to(torch.int32).contiguous()
    route = stats_route(h.dtype, hid)
    if route != "simt":
        return _stats_tc(h, w, b, lbl, out, n, v, hid, route)
    _fits("xent_stats kernel", hid, stats_smem(hid))
    # two blocks fit on an SM: aim for two waves of them
    nsplit, per = _split_plan(n, v, 4 * _sms(h))
    part = (torch.empty((nsplit, 4, n), dtype=torch.float32,
                        device=h.device) if nsplit > 1 else None)
    KERNEL_STATS(code, core.ptr(h), core.ptr(w), core.ptr(b), core.ptr(lbl),
                 core.ptr(out), core.ptr(part), n, v, hid, nsplit, per,
                 core.stream(h))
    return out


XENT_STATS_OP = core.define_op(
    KERNEL_STATS, "(Tensor h, Tensor w, Tensor? b, Tensor labels) -> "
    "Tensor", _xent_stats_cuda,
    lambda h, w, b, labels: h.new_empty((4, h.shape[0]),
                                        dtype=torch.float32))


def xent_stats_kernel(h, w, b, labels):
    """K5 on CUDA tensors, through its op; same outputs as the plain
    version: ``(m, s, picked, sum_logits)``, each ``[N]`` f32."""
    return tuple(XENT_STATS_OP(h, w, b, labels))


def xent_stats(h, w, b, labels):
    """``(m, s, picked, sum_logits)`` per row: K5 on CUDA tensors, the
    plain version on CPU tensors."""
    if core.on_card(h, w, b, labels):
        return xent_stats_kernel(h, w, b, labels)
    return xent_stats_plain(h, w, b, labels)


def xent_bwd_plain(h, w, b, labels, logz, g, sn, sp, chunk=CHUNK):
    """``(dh [N, H], dw [V, H], db [V])`` f32 for the per-row cotangent
    ``g`` — the chunk loop of the reference's ``_xent_bwd_impl``."""
    v = w.shape[0]
    hf = h.float()
    dh = torch.zeros(h.shape, dtype=torch.float32, device=h.device)
    dw_parts, db_parts = [], []
    for c0 in range(0, v, chunk):
        c1 = min(c0 + chunk, v)
        logits = _chunk_logits(h, w, b, c0, c1)
        p = torch.exp(logits - logz[:, None])
        hit = _hit(labels, c0, c1).float()
        gch = (p - sn - (sp - sn) * hit) * g.float()[:, None]
        dh = dh + gch @ w[c0:c1].float()
        dw_parts.append(gch.T @ hf)
        db_parts.append(gch.sum(dim=0))
    return dh, torch.cat(dw_parts), torch.cat(db_parts)


def _bwd_setup(h, w, b, labels, logz, g, what, resident):
    """``(code, n, v, hid, route, plan, ptrs, operands)``. The route is
    :func:`bwd_route`'s, the plan its own (:func:`tc_plan`,
    :func:`x3_plan` or :func:`simt_plan`) over ``resident`` rows (N for
    dh, V for dw/db). The caller holds ``operands`` (labels, logz and g
    converted for the kernel, and h and w, copied where the tf32x3 route
    needs them aligned) until the launch: a converted copy freed before its kernel is enqueued goes back
    to the caching allocator, and the next allocation on the stream (the
    kernel's own output) may be handed the same memory."""
    code, n, v, hid = _check(h, w, b, labels, what)
    res, streamed = (n, v) if resident == "rows" else (v, n)
    route = bwd_route(h.dtype, hid)
    if route == "simt":
        plan = dict(simt_plan(res, streamed, hid, _sms(h)), stages=0)
    elif route == "tc":
        plan = tc_plan(res, streamed, hid, _sms(h))
        if h.data_ptr() % 16 or w.data_ptr() % 16:
            raise ValueError(f"{what}: bf16 h and weight must start on a "
                             "16-byte boundary (TMA)")
    else:
        plan = x3_plan(res, streamed, hid, _sms(h))
        # TMA reads 16-byte aligned rows: a misaligned operand is copied
        h, w = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (h, w))
    operands = (labels.to(torch.int32).contiguous(),
                logz.float().contiguous(), g.float().contiguous(), h, w)
    ptrs = (core.ptr(h), core.ptr(w), core.ptr(b),
            *(core.ptr(t) for t in operands[:3]))
    return code, n, v, hid, route, plan, ptrs, operands


def _plan_args(plan):
    return plan["splits"], plan["per"], plan["chunks"], plan["stages"]


def _xent_dh_cuda(h, w, b, labels, logz, g, sn, sp):
    """K6's dh op on CUDA tensors: one launch -> dh ``[N, H]`` f32."""
    code, n, v, hid, route, plan, ptrs, operands = _bwd_setup(
        h, w, b, labels, logz, g, "xent_bwd_dh kernel", "rows")
    dh = torch.empty((n, hid), dtype=torch.float32, device=h.device)
    if n == 0 or v == 0:
        return dh.zero_()
    part = (torch.empty((plan["splits"], n, hid), dtype=torch.float32,
                        device=h.device) if plan["splits"] > 1 else None)
    KERNEL_DH(code, *ptrs, core.ptr(dh), core.ptr(part), n, v, hid,
              *_plan_args(plan), float(sn), float(sp), core.stream(h),
              route=route)
    del operands                     # enqueued: stream order protects them
    return dh


def _xent_dwb_cuda(h, w, b, labels, logz, g, sn, sp):
    """K6's dw/db op on CUDA tensors: one launch -> ``(dw [V, H], db
    [V])`` f32."""
    code, n, v, hid, route, plan, ptrs, operands = _bwd_setup(
        h, w, b, labels, logz, g, "xent_bwd_dwb kernel", "vocab")
    dw = torch.empty((v, hid), dtype=torch.float32, device=h.device)
    db = torch.empty(v, dtype=torch.float32, device=h.device)
    if n == 0 or v == 0:
        return dw.zero_(), db.zero_()
    part, db_part = None, None
    if plan["splits"] > 1:
        part = torch.empty((plan["splits"], v, hid), dtype=torch.float32,
                           device=h.device)
        db_part = torch.empty((plan["splits"], v), dtype=torch.float32,
                              device=h.device)
    KERNEL_DWB(code, *ptrs, core.ptr(dw), core.ptr(db), core.ptr(part),
               core.ptr(db_part), n, v, hid, *_plan_args(plan), float(sn),
               float(sp), core.stream(h), route=route)
    del operands                     # enqueued: stream order protects them
    return dw, db


_BWD_SCHEMA = ("(Tensor h, Tensor w, Tensor? b, Tensor labels, Tensor logz, "
               "Tensor g, float sn, float sp)")
XENT_DH_OP = core.define_op(
    KERNEL_DH, _BWD_SCHEMA + " -> Tensor", _xent_dh_cuda,
    lambda h, w, b, labels, logz, g, sn, sp: h.new_empty(
        h.shape, dtype=torch.float32))
XENT_DWB_OP = core.define_op(
    KERNEL_DWB, _BWD_SCHEMA + " -> (Tensor, Tensor)", _xent_dwb_cuda,
    lambda h, w, b, labels, logz, g, sn, sp: (
        w.new_empty(w.shape, dtype=torch.float32),
        w.new_empty(w.shape[:1], dtype=torch.float32)))


def xent_bwd_dh_kernel(h, w, b, labels, logz, g, sn, sp):
    """K6's dh kernel on CUDA tensors, through its op -> dh ``[N, H]``
    f32."""
    return XENT_DH_OP(h, w, b, labels, logz, g, float(sn), float(sp))


def xent_bwd_dwb_kernel(h, w, b, labels, logz, g, sn, sp):
    """K6's dw/db kernel on CUDA tensors, through its op -> ``(dw [V, H],
    db [V])`` f32."""
    return XENT_DWB_OP(h, w, b, labels, logz, g, float(sn), float(sp))


def xent_bwd_kernel(h, w, b, labels, logz, g, sn, sp):
    """K6 on CUDA tensors: the dh kernel, then the dw/db kernel; same
    outputs as the plain version."""
    dh = xent_bwd_dh_kernel(h, w, b, labels, logz, g, sn, sp)
    dw, db = xent_bwd_dwb_kernel(h, w, b, labels, logz, g, sn, sp)
    return dh, dw, db


def xent_bwd(h, w, b, labels, logz, g, sn, sp):
    """``(dh, dw, db)`` f32: K6 on CUDA tensors, the plain version on CPU
    tensors."""
    if core.on_card(h, w, b, labels, logz, g):
        return xent_bwd_kernel(h, w, b, labels, logz, g, sn, sp)
    return xent_bwd_plain(h, w, b, labels, logz, g, sn, sp)
