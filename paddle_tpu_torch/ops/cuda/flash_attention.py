"""K2 and K3: flash-attention forward and backward — the CUDA kernels and
their plain PyTorch versions.

K2 replaces ``paddle_tpu/ops/pallas/flash_attention.py:64 _fa_kernel``
(launcher ``_flash_attention_fwd_tpu`` :112, entry ``flash_attention``
:510). The TPU kernel's sequential kv grid axis, which carries
(m, l, acc) in VMEM, becomes a loop over the kv tiles inside a block.

K3 replaces ``:180 _fa_bwd_dq_kernel`` and ``:232 _fa_bwd_dkv_kernel``
(launcher ``_flash_attention_bwd_tpu`` :289). Two kernels recompute
``p = exp(s - lse)`` from K2's saved lse; ``delta = rowsum(dO * O)`` is
computed here in torch, as the reference computes it in XLA (:299).

Two routes for K2, chosen by :func:`flash_route`, and three for K3, chosen
by :func:`flash_bwd_route`, rules on the storage type and the head dim:

* ``"tc"`` — bf16 with D = 64 or 128 (the training paths): persistent
  ``wgmma`` kernels fed by TMA (``csrc/flash_attention_tc.cu``,
  ``csrc/flash_attention_bwd_tc.cu``, ``csrc/flash_tc.cuh``); the
  probabilities (and K3's dS) are rounded to bf16 in registers for the
  products that take them. Inputs that do not start on 16 bytes are
  copied (TMA's alignment).
* ``"tf32x3"`` — K3 only, f32 with D = 64 (the program path's and the
  f32 crosschecks' backward): 3xTF32 ``wgmma``
  (``csrc/flash_attention_bwd_x3.cu``; each f32 operand split hi =
  tf32(x), lo = tf32(x - hi), each product lo·hi + hi·lo + hi·hi), P and
  dS split in registers, never rounded to bf16; :func:`x3_plan` says
  what it takes. Inputs that do not start on 16 bytes are copied (TMA's
  alignment).
* ``"simt"`` — K2 in f32 at every head dim, K3 in f32 at D = 16, 32 and
  128, both in bf16 at D = 16 or 32 (serving's f32 prefill): the CUDA
  cores in f32 (``csrc/flash_attention.cu``,
  ``csrc/flash_attention_bwd.cu``). K2's
  simt kernel walks work items of :func:`flash_plan`: a query tile's kv
  tiles cut into chunks where the heads' tiles alone would leave the
  card's block slots idle, longest items first, the chunks' (m, l, acc)
  partials merged in a fixed order by a second kernel of the same
  launch.

A CUDA launch that fails raises; no route gives way to another.

The plain versions are the reference's ``chunked_attention`` (:379) for
the forward (the same online softmax over kv chunks, with the same masking
rules: bottom-right causal offset ``tk - tq``, key-padding mask, fully
masked rows exactly 0) and ``_flash_attention_bwd_tpu``'s math for the
backward. :class:`FlashAttentionFunction` pairs K2 and K3 (or the two
plain versions on CPU tensors) as one differentiable op.

On the card the three kernels are reached through their ops
(``core.define_op``): ``torch.ops.paddle_tpu_torch.flash_attention``
returns ``(out, lse)``, ``.flash_attention_bwd_dq`` dq and
``.flash_attention_bwd_dkv`` ``(dk, dv)``. The ops take the key mask as
``Tensor?``; the copies TMA's alignment needs, the int32 mask and the
launch happen inside them.
"""

import ctypes
import math

import torch

from paddle_tpu_torch.ops.cuda import core

# every entry takes (dtype code, on the simt route only), the operand
# pointers, B, H, Tq, Tk, D, scale, causal and the stream; K2's simt entry
# also its partials' scratch and its plan (chunk, item count, items)
_FWD_ARGS = [core.VP] * 6 + [core.I32] * 5 + [core.F32_ARG, core.I32,
                                              core.VP]
_FWD_SIMT_ARGS = ([core.I32] + [core.VP] * 7 + [core.I32] * 5
                  + [core.F32_ARG] + [core.I32] * 3 + [core.VP] * 2)
KERNEL = core.register(
    "flash_attention", "ptt_flash_attention", _FWD_SIMT_ARGS,
    replaces="paddle_tpu/ops/pallas/flash_attention.py:64",
    source="paddle_tpu_torch/csrc/flash_attention.cu",
    routes={"tc": ("ptt_flash_attention_tc", _FWD_ARGS)},
    route_sources={"tc": "paddle_tpu_torch/csrc/flash_attention_tc.cu"})
_DQ_ARGS = [core.VP] * 8 + [core.I32] * 5 + [core.F32_ARG, core.I32,
                                             core.VP]
_BWD_X3_SOURCE = "paddle_tpu_torch/csrc/flash_attention_bwd_x3.cu"
KERNEL_BWD_DQ = core.register(
    "flash_attention_bwd_dq", "ptt_flash_attention_bwd_dq",
    [core.I32] + _DQ_ARGS,
    replaces="paddle_tpu/ops/pallas/flash_attention.py:180",
    source="paddle_tpu_torch/csrc/flash_attention_bwd.cu",
    routes={"tc": ("ptt_flash_attention_bwd_dq_tc", _DQ_ARGS),
            "tf32x3": ("ptt_flash_attention_bwd_dq_x3", _DQ_ARGS)},
    route_sources={"tc": "paddle_tpu_torch/csrc/flash_attention_bwd_tc.cu",
                   "tf32x3": _BWD_X3_SOURCE})
_DKV_ARGS = [core.VP] * 9 + [core.I32] * 5 + [core.F32_ARG, core.I32,
                                              core.VP]
KERNEL_BWD_DKV = core.register(
    "flash_attention_bwd_dkv", "ptt_flash_attention_bwd_dkv",
    [core.I32] + _DKV_ARGS,
    replaces="paddle_tpu/ops/pallas/flash_attention.py:232",
    source="paddle_tpu_torch/csrc/flash_attention_bwd.cu",
    routes={"tc": ("ptt_flash_attention_bwd_dkv_tc", _DKV_ARGS),
            "tf32x3": ("ptt_flash_attention_bwd_dkv_x3", _DKV_ARGS)},
    route_sources={"tc": "paddle_tpu_torch/csrc/flash_attention_bwd_tc.cu",
                   "tf32x3": _BWD_X3_SOURCE})

NEG_INF = -1e30
#: the reference's default kv block (flag flash_block_k), which is also
#: the chunk of its CPU path
CHUNK = 512
HEAD_DIMS = (16, 32, 64, 128)
#: the head dims of the tc route: one or two [64, 64] TMA boxes per row
TC_HEAD_DIMS = (64, 128)
#: K3's tf32x3 route (csrc/flash_attention_bwd_x3.cu): its head dims, the
#: rows of a tile, the ring's stages, and the [64, 64] f32 tiles of a
#: block's shared memory besides the ring (its resident tiles, hi and lo,
#: and the work tiles: the streamed tiles' lo parts and staged transposes)
X3_HEAD_DIMS = (64,)
X3_TILE, X3_STAGES = 64, 2
X3_TILES = {"dq": 4 + 6, "dkv": 4 + 6}
_X3_TILE_BYTES = X3_TILE * 64 * 4
#: K2's simt route (csrc/flash_attention.cu): query rows of an item, keys
#: of a kv tile, the most items of a split plan
FLASH_ROWS, FLASH_KEYS, FLASH_MAX_ITEMS = 64, 64, 512
#: the query tiles and kv tiles an item's code can name: 12 bits for the
#: query tile, 10 for each kv tile bound (the end one may equal the count)
FLASH_CODE_Q_TILES, FLASH_CODE_KV_TILES = 1 << 12, (1 << 10) - 1


def flash_route(dtype, d):
    """K2's route: ``"tc"`` (the bf16 wgmma kernel) for bf16 with a head
    dim of 64 or 128, else ``"simt"`` (f32 at every head dim, bf16 at 16
    and 32). A launch on either route that fails raises."""
    if dtype == torch.bfloat16 and d in TC_HEAD_DIMS:
        return "tc"
    return "simt"


def flash_bwd_route(dtype, d):
    """K3's route: ``"tc"`` for bf16 with a head dim of 64 or 128,
    ``"tf32x3"`` (3xTF32 wgmma) for f32 at a head dim of
    :data:`X3_HEAD_DIMS`, else ``"simt"`` (f32 at 16, 32 and 128, bf16 at
    16 and 32). A launch on any route that fails raises."""
    if dtype == torch.bfloat16 and d in TC_HEAD_DIMS:
        return "tc"
    if dtype == torch.float32 and d in X3_HEAD_DIMS:
        return "tf32x3"
    return "simt"


def x3_smem(kernel):
    """Shared memory of a block of K3's tf32x3 ``kernel`` (``"dq"`` or
    ``"dkv"``; ``csrc/flash_attention_bwd_x3.cu kDqSmem``, ``kDkvSmem``):
    1 KB of alignment, the ring (two raw tiles a stage), the resident and
    work tiles, dk/dv's lse and delta of a tile, the barriers."""
    side = 2 * X3_TILE * 4 if kernel == "dkv" else 0
    return (1024 + (2 * X3_STAGES + X3_TILES[kernel]) * _X3_TILE_BYTES
            + side + 8 * (X3_STAGES + 1))


def x3_plan(d):
    """K3's launch plan on the tf32x3 route: ``dict(dq_smem, dkv_smem,
    stages)``, one block of 128 threads over each 64-row resident tile.
    Raises ``ValueError`` for a head dim the route does not take or a
    block that does not fit :data:`core.MAX_SMEM`; it never falls back."""
    what = "flash backward (f32, tf32x3)"
    if d not in X3_HEAD_DIMS:
        raise ValueError(f"{what}: head dim {d} not in {X3_HEAD_DIMS}")
    plan = dict(dq_smem=x3_smem("dq"), dkv_smem=x3_smem("dkv"),
                stages=X3_STAGES)
    for kernel in ("dq", "dkv"):
        if plan[f"{kernel}_smem"] > core.MAX_SMEM:
            raise ValueError(f"{what}: the {kernel} block needs "
                             f"{plan[kernel + '_smem']} bytes of shared "
                             f"memory > {core.MAX_SMEM}")
    return plan


def flash_kv_tiles(tq, tk, causal):
    """The kv tiles each query tile of K2's simt route walks: all of
    them, or (causal) those up to the tile that holds the diagonal key of
    its last real row."""
    nq, nk = -(-tq // FLASH_ROWS), -(-tk // FLASH_KEYS)
    if not causal:
        return [nk] * nq
    out = []
    for qi in range(nq):
        last = min(qi * FLASH_ROWS + FLASH_ROWS - 1, tq - 1) + tk - tq
        out.append(0 if last < 0 else min(nk, last // FLASH_KEYS + 1))
    return out


def flash_plan(bh, tq, tk, causal, slots):
    """K2's simt work split: ``(chunk, items)``. Each query tile's kv
    tiles are cut into chunks of at most ``chunk`` tiles: the kv tiles of
    all ``bh`` heads over the card's resident block ``slots`` for the
    kernel (``core.resident_slots``), rounded up, so that no item is
    longer than a slot's share. ``items`` lists each head's ``(query tile, first
    kv tile, end kv tile)`` longest first (then the later query tile
    first, then the earlier chunk); a query tile with no kv tile is one
    empty item. Where the chunk covers every query tile's tiles, or the
    list would pass :data:`FLASH_MAX_ITEMS`, or its tiles would not fit
    an item's code (:func:`flash_item_code`), the plan does not split:
    ``items`` is None and item r is query tile ``nq - 1 - r`` over all its
    tiles, which is also longest first."""
    tiles = flash_kv_tiles(tq, tk, causal)
    longest = max(tiles)
    if (len(tiles) > FLASH_CODE_Q_TILES
            or -(-tk // FLASH_KEYS) > FLASH_CODE_KV_TILES):
        return max(1, longest), None
    chunk = max(1, -(-bh * sum(max(1, n) for n in tiles) // slots))
    if chunk >= longest:
        return max(1, longest), None
    items = sorted(((min(n, j + chunk) - j, qi, j)
                    for qi, n in enumerate(tiles)
                    for j in (range(0, n, chunk) if n else (0,))),
                   key=lambda e: (-e[0], -e[1], e[2]))
    if len(items) > FLASH_MAX_ITEMS:
        return longest, None
    return chunk, [(qi, j, j + size) for size, qi, j in items]


def flash_item_code(qi, t0, t1):
    """A split plan's item as the kernel reads it: ``qi << 20 | t0 << 10
    | t1``; raises for tiles that the code cannot hold (the plan keeps
    such shapes unsplit)."""
    if not (0 <= qi < FLASH_CODE_Q_TILES
            and 0 <= t0 <= t1 <= FLASH_CODE_KV_TILES):
        raise ValueError(f"flash plan item ({qi}, {t0}, {t1}) does not fit "
                         "its code")
    return (qi << 20) | (t0 << 10) | t1


def _launch(kernel, code, route, *args):
    """Launch ``kernel`` on ``route``; the simt entry takes the storage
    type's code first, the tc entry is bf16 only, the tf32x3 entry f32
    only."""
    if route in ("tc", "tf32x3"):
        kernel(*args, route=route)
    else:
        kernel(code, *args)


def _aligned(*ts):
    """TMA reads from 16-byte aligned bases: a tensor that does not start
    on 16 bytes is copied (a fresh allocation does); the tc and tf32x3
    routes take their operands through it."""
    return [t if t is None or t.data_ptr() % 16 == 0 else t.clone()
            for t in ts]


def chunked_attention(q, k, v, scale=None, causal=False, kv_mask=None,
                      chunk_size=CHUNK, return_lse=False):
    """Online-softmax attention over kv chunks in plain PyTorch (the
    reference's ``chunked_attention``). q ``[B, H, Tq, D]``, k/v
    ``[B, H, Tk, D]``, kv_mask ``[B, Tk]`` (True = attend). Accumulates
    in f32; fully masked rows give exactly 0. With ``return_lse`` also
    returns the per-row logsumexp ``[B, H, Tq]`` f32, as the kernel
    writes it."""
    b, h, tq, d = q.shape
    tk = k.shape[2]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    chunk = max(1, min(chunk_size, tk))
    qf = q.float()
    q_pos = torch.arange(tq, device=q.device) + (tk - tq)
    m = torch.full((b, h, tq, 1), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, h, tq, 1), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, h, tq, d), dtype=torch.float32, device=q.device)
    for c0 in range(0, tk, chunk):
        kb = k[:, :, c0:c0 + chunk].float()
        vb = v[:, :, c0:c0 + chunk].float()
        k_pos = torch.arange(c0, c0 + kb.shape[2], device=q.device)
        s = torch.einsum("bhqd,bhkd->bhqk", qf, kb) * scale
        valid = torch.ones_like(s, dtype=torch.bool)
        if causal:
            valid = valid & (q_pos[:, None] >= k_pos[None, :])[None, None]
        if kv_mask is not None:
            mb = kv_mask[:, c0:c0 + chunk].bool()
            valid = valid & mb[:, None, None, :]
        s = torch.where(valid, s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        # mask p, not just s: a fully masked row keeps m at NEG_INF where
        # exp(s - m) would be 1
        p = torch.where(valid, torch.exp(s - m_new), torch.zeros_like(s))
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + torch.einsum("bhqk,bhkd->bhqd", p, vb)
        m = m_new
    out = torch.where(l > 0, acc / torch.clamp(l, min=1e-30),
                      torch.zeros_like(acc)).to(q.dtype)
    if return_lse:
        lse = (m + torch.log(torch.clamp(l, min=1e-30)))[..., 0]
        return out, lse
    return out


def _flash_fwd_cuda(q, k, v, kv_mask, scale, causal):
    """K2's op on CUDA tensors: one launch on the route
    :func:`flash_route` picks."""
    b, h, tq, tk, d, code = _check_qkv(q, k, v, kv_mask, "flash kernel")
    core.require_contiguous(q=q, k=k, v=v)
    mask = (kv_mask.to(torch.int32).contiguous() if kv_mask is not None
            else None)
    route = flash_route(q.dtype, d)
    if route == "tc":
        q, k, v = _aligned(q, k, v)
    out = torch.empty_like(q)
    lse = torch.empty((b, h, tq), dtype=torch.float32, device=q.device)
    if q.numel() == 0 or k.numel() == 0:
        # no key: every row is fully masked (out 0, lse the sentinel, as
        # chunked_attention gives them)
        return out.zero_(), lse.fill_(NEG_INF)
    if route == "tc":
        KERNEL(core.ptr(q), core.ptr(k), core.ptr(v), core.ptr(mask),
               core.ptr(out), core.ptr(lse), b, h, tq, tk, d, float(scale),
               int(bool(causal)), core.stream(q), route="tc")
        return out, lse
    chunk, items = flash_plan(
        b * h, tq, tk, causal,
        core.resident_slots("ptt_flash_attention_resident", code, d))
    part = codes = None
    if items:
        # a (query tile, chunk) slot per row of partials, as the kernel
        # lays them out: [b * h, nq, ceil(nk / chunk), 64] x (D + 2)
        nq, nk = -(-tq // FLASH_ROWS), -(-tk // FLASH_KEYS)
        part = torch.empty(b * h * nq * -(-nk // chunk) * FLASH_ROWS
                           * (d + 2),
                           dtype=torch.float32, device=q.device)
        codes = (ctypes.c_uint * len(items))(
            *(flash_item_code(*item) for item in items))
    KERNEL(code, core.ptr(q), core.ptr(k), core.ptr(v), core.ptr(mask),
           core.ptr(out), core.ptr(lse), core.ptr(part), b, h, tq, tk, d,
           float(scale), int(bool(causal)), chunk,
           len(items) if items else 0, codes, core.stream(q))
    del part                 # enqueued: stream order protects the scratch
    return out, lse


FLASH_OP = core.define_op(
    KERNEL, "(Tensor q, Tensor k, Tensor v, Tensor? kv_mask, float scale, "
    "bool causal) -> (Tensor, Tensor)", _flash_fwd_cuda,
    lambda q, k, v, kv_mask, scale, causal: (
        torch.empty_like(q),
        q.new_empty(q.shape[:3], dtype=torch.float32)))


def flash_attention_kernel(q, k, v, scale, causal=False, kv_mask=None):
    """K2 on CUDA tensors, through its op -> ``(out [B, H, Tq, D], lse
    [B, H, Tq] f32)``."""
    return FLASH_OP(q, k, v, kv_mask, float(scale), bool(causal))


def _check_qkv(q, k, v, kv_mask, what):
    """(b, h, tq, tk, d, dtype code); raises for what the kernels do not
    take."""
    code = core.dtype_code(q, (torch.float32, torch.bfloat16))
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{what}: q, k and v must share one dtype")
    b, h, tq, d = q.shape
    tk = k.shape[2]
    if d not in HEAD_DIMS:
        raise ValueError(f"{what}: head dim {d} not in {HEAD_DIMS}")
    if k.shape != (b, h, tk, d) or v.shape != k.shape:
        raise ValueError(f"{what}: k/v {tuple(k.shape)} {tuple(v.shape)} "
                         f"do not match q {tuple(q.shape)}")
    if kv_mask is not None and kv_mask.shape != (b, tk):
        raise ValueError(f"kv_mask must be [{b}, {tk}]")
    return b, h, tq, tk, d, code


def _valid(tq, tk, causal, kv_mask, device):
    """[B or 1, 1, Tq, Tk] bool: which (query, key) pairs attend."""
    q_pos = torch.arange(tq, device=device) + (tk - tq)
    k_pos = torch.arange(tk, device=device)
    valid = torch.ones((1, 1, tq, tk), dtype=torch.bool, device=device)
    if causal:
        valid = valid & (q_pos[:, None] >= k_pos[None, :])[None, None]
    if kv_mask is not None:
        valid = valid & kv_mask.bool()[:, None, None, :]
    return valid


def flash_attention_bwd_plain(q, k, v, out, lse, do, scale, causal=False,
                              kv_mask=None):
    """The plain backward: ``_flash_attention_bwd_tpu``'s math over the
    whole score matrix, in f32. ``lse`` ``[B, H, Tq]`` f32 from the
    forward. Returns ``(dq, dk, dv)`` in q's dtype. Masked pairs give
    p = 0 exactly (selected, so the overflowed exp of a fully masked
    row's -1e30 lse is discarded)."""
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    delta = (dof * out.float()).sum(-1)                     # [B, H, Tq]
    s = torch.einsum("bhqd,bhkd->bhqk", qf, kf) * scale
    valid = _valid(q.shape[2], k.shape[2], causal, kv_mask, q.device)
    p = torch.where(valid, torch.exp(s - lse[..., None]),
                    torch.zeros_like(s))
    dv = torch.einsum("bhqk,bhqd->bhkd", p, dof)
    dp = torch.einsum("bhqd,bhkd->bhqk", dof, vf)
    ds = p * (dp - delta[..., None]) * scale
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kf)
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, qf)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _bwd_setup(q, k, v, do, lse, delta, causal, kv_mask, scale):
    b, h, tq, tk, d, code = _check_qkv(q, k, v, kv_mask,
                                       "flash backward kernel")
    if do.shape != q.shape or do.dtype != q.dtype:
        raise ValueError("flash backward kernel: dO must match q's shape "
                         "and dtype")
    if lse.shape != (b, h, tq) or delta.shape != (b, h, tq):
        raise ValueError(f"flash backward kernel: lse and delta must be "
                         f"[{b}, {h}, {tq}]")
    core.require_contiguous(q=q, k=k, v=v, do=do)
    route = flash_bwd_route(q.dtype, d)
    if route == "tf32x3":
        x3_plan(d)
    if route != "simt":
        q, k, v, do = _aligned(q, k, v, do)
    # the caller holds these converted operands until the launch: a copy
    # freed before its kernel is enqueued goes back to the caching
    # allocator, and the kernel's own output may be handed the same memory
    operands = (q, k, v, do, lse.float().contiguous(),
                delta.float().contiguous(),
                kv_mask.to(torch.int32).contiguous() if kv_mask is not None
                else None)
    ptrs = tuple(core.ptr(t) for t in operands)
    dims = (b, h, tq, tk, d, float(scale), int(bool(causal)),
            core.stream(q))
    return code, route, ptrs, dims, operands


def _flash_dq_cuda(q, k, v, do, lse, delta, kv_mask, scale, causal):
    """K3's dq op on CUDA tensors: one launch."""
    code, route, ptrs, dims, operands = _bwd_setup(
        q, k, v, do, lse, delta, causal, kv_mask, scale)
    dq = torch.empty_like(q)
    if q.numel() == 0 or k.numel() == 0:
        return dq.zero_()
    _launch(KERNEL_BWD_DQ, code, route, *ptrs, core.ptr(dq), *dims)
    del operands                     # enqueued: stream order protects them
    return dq


def _flash_dkv_cuda(q, k, v, do, lse, delta, kv_mask, scale, causal):
    """K3's dk/dv op on CUDA tensors: one launch."""
    code, route, ptrs, dims, operands = _bwd_setup(
        q, k, v, do, lse, delta, causal, kv_mask, scale)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    if q.numel() == 0 or k.numel() == 0:
        return dk.zero_(), dv.zero_()
    _launch(KERNEL_BWD_DKV, code, route, *ptrs, core.ptr(dk), core.ptr(dv),
            *dims)
    del operands                     # enqueued: stream order protects them
    return dk, dv


_BWD_SCHEMA = ("(Tensor q, Tensor k, Tensor v, Tensor do, Tensor lse, "
               "Tensor delta, Tensor? kv_mask, float scale, bool causal)")
FLASH_DQ_OP = core.define_op(
    KERNEL_BWD_DQ, _BWD_SCHEMA + " -> Tensor", _flash_dq_cuda,
    lambda q, k, v, do, lse, delta, kv_mask, scale, causal:
    torch.empty_like(q))
FLASH_DKV_OP = core.define_op(
    KERNEL_BWD_DKV, _BWD_SCHEMA + " -> (Tensor, Tensor)", _flash_dkv_cuda,
    lambda q, k, v, do, lse, delta, kv_mask, scale, causal:
    (torch.empty_like(k), torch.empty_like(v)))


def flash_attention_bwd_dq_kernel(q, k, v, do, lse, delta, scale,
                                  causal=False, kv_mask=None):
    """K3's dq kernel on CUDA tensors, through its op -> dq like q.
    ``delta`` is ``rowsum(dO * O)`` ``[B, H, Tq]`` f32."""
    return FLASH_DQ_OP(q, k, v, do, lse, delta, kv_mask, float(scale),
                       bool(causal))


def flash_attention_bwd_dkv_kernel(q, k, v, do, lse, delta, scale,
                                   causal=False, kv_mask=None):
    """K3's dk/dv kernel on CUDA tensors, through its op -> ``(dk, dv)``
    like k."""
    return FLASH_DKV_OP(q, k, v, do, lse, delta, kv_mask, float(scale),
                        bool(causal))


def flash_attention_bwd_kernel(q, k, v, out, lse, do, scale, causal=False,
                               kv_mask=None):
    """K3 on CUDA tensors: ``delta = rowsum(dO * O)`` in torch, then the
    dq kernel and the dk/dv kernel; same outputs as the plain version.
    Every operand must be contiguous: the gradient arrives as a
    transposed view, so the caller makes it contiguous."""
    delta = (do.float() * out.float()).sum(-1)
    dq = flash_attention_bwd_dq_kernel(q, k, v, do, lse, delta, scale,
                                       causal, kv_mask)
    dk, dv = flash_attention_bwd_dkv_kernel(q, k, v, do, lse, delta, scale,
                                            causal, kv_mask)
    return dq, dk, dv


class FlashAttentionFunction(torch.autograd.Function):
    """Flash attention as one differentiable op (the reference's
    ``_flash_core`` custom_vjp): K2 forward saving lse, K3 backward on
    CUDA tensors; the chunked plain forward and the plain backward on CPU
    tensors, so the CPU runs the kernels' exact backward math."""

    @staticmethod
    def forward(ctx, q, k, v, kv_mask, scale, causal):
        if core.on_card(q, k, v, kv_mask):
            out, lse = flash_attention_kernel(q.contiguous(), k.contiguous(),
                                              v.contiguous(), scale, causal,
                                              kv_mask)
        else:
            out, lse = chunked_attention(q, k, v, scale=scale, causal=causal,
                                         kv_mask=kv_mask, return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse, kv_mask)
        ctx.scale, ctx.causal = scale, causal
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse, kv_mask = ctx.saved_tensors
        if core.on_card(q, k, v, dout):
            dq, dk, dv = flash_attention_bwd_kernel(
                q.contiguous(), k.contiguous(), v.contiguous(), out, lse,
                dout.to(q.dtype).contiguous(), ctx.scale, ctx.causal,
                kv_mask)
        else:
            dq, dk, dv = flash_attention_bwd_plain(
                q, k, v, out, lse, dout, ctx.scale, ctx.causal, kv_mask)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, scale=None, causal=False, kv_mask=None):
    """Memory-efficient attention. q, k, v ``[B, H, T, D]``; kv_mask
    ``[B, Tk]`` (True = attend). Differentiable: K2 forward and K3
    backward on CUDA tensors, the plain versions on CPU tensors."""
    scale = float(scale) if scale is not None else 1.0 / math.sqrt(
        q.shape[-1])
    return FlashAttentionFunction.apply(q, k, v, kv_mask, scale, causal)
