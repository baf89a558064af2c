"""K7: paged decode attention — the CUDA kernels and the plain PyTorch
version.

Replaces ``paddle_tpu/ops/pallas/decode_attention.py:48 _decode_kernel``
(launcher ``paged_decode_attention_tpu`` :114), for f32, bf16 and int8
pools (the int8 variant is the same TPU kernel behind its ``quantized``
switch, dequantizing rows with ``[N, ps]`` scales). Source:
``paddle_tpu_torch/csrc/decode_attention.cu``. The scalar prefetch of the
page table has no counterpart: each block reads ``page_table[s, j]``
itself and skips the pages at or past the slot's length. Bound on the
H100: bytes (each live K/V element is read once for two FMAs).

Two routes, chosen by :func:`decode_route` from the head dim alone:

* ``"split"`` (head dims that are multiples of 8 up to 256):
  flash-decoding. Each slot's page-table entries are cut into splits of
  ``per`` entries (:func:`split_plan`, from the SM count and ``pmax``,
  never from the lengths, so a launch needs no host sync and can be
  captured in a CUDA graph); one block per (split, head, slot) reads its
  rows in vector loads into registers and writes a partial ``(m, l,
  acc)`` to an f32 workspace, and the last block of a (slot, head) to
  finish, found by an atomic ticket, merges the partials in split order
  (bitwise repeatable) and sets its ticket back to 0.
* ``"simt"`` (other head dims): one block per (head, slot) walks its
  pages through shared memory.

The plain version is the reference's ``_paged_attention_xla``
(``ops/attention.py:190``): it gathers every table page densely and masks
by length.

On the card the kernel is reached through its op,
``torch.ops.paddle_tpu_torch.decode_attention`` (``core.define_op``),
with the int8 pools' scales as ``Tensor?``. The route, the split plan
(which reads the SM count), the 16-byte checks of the pools, the split
workspace and the tickets all live inside the op, so a traced program
holds one op per layer and nothing of the plan.
"""

import math

import torch

from paddle_tpu_torch.ops.cuda import core

KERNEL = core.register(
    "decode_attention", "ptt_decode_attention",
    [core.I32] + [core.VP] * 8 + [core.I32] * 6 + [core.F32_ARG, core.VP],
    replaces="paddle_tpu/ops/pallas/decode_attention.py:48",
    source="paddle_tpu_torch/csrc/decode_attention.cu",
    routes={"split": ("ptt_decode_attention_split",
                      [core.I32] + [core.VP] * 10 + [core.I32] * 8
                      + [core.F32_ARG, core.VP])})

NEG_INF = -1e30

#: the split route: elements of a row one lane reads, the widest head dim
CHUNK, SPLIT_MAX_HD = 8, 256
#: blocks the split plan aims for, per SM: enough that the blocks of the
#: live splits spread over every SM in several waves
SPLIT_BLOCKS_PER_SM = 16
#: the most page-table entries one split stages in shared memory
SPLIT_MAX_PER = 2048


#: per device, the split route's tickets (one int32 per slot and head):
#: zero before and after every launch, since the block that takes a
#: ticket's merge sets it back to 0. Every buffer made is kept, so a
#: CUDA graph captured over an older one stays valid. Launches on two
#: streams of one device must not overlap: they would share tickets.
_TICKETS = {}


def _tickets(device, n):
    """A zeroed int32 buffer of at least ``n`` tickets on ``device``,
    made outside any CUDA graph capture (run the kernel once before
    capturing it)."""
    made = _TICKETS.setdefault(device, [])
    if not made or made[-1].numel() < n:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("decode kernel: launch it once before CUDA "
                               "graph capture (its tickets are made then)")
        made.append(torch.zeros(max(n, 1024), dtype=torch.int32,
                                device=device))
    return made[-1]


def decode_route(hd):
    """K7's route: ``"split"`` for a head dim that is a multiple of 8 of
    at most 256 (whole 8-element chunks, at most one per lane of a warp),
    else ``"simt"``."""
    return "split" if hd % CHUNK == 0 and 0 < hd <= SPLIT_MAX_HD else "simt"


def split_plan(slots, heads, pmax, sms):
    """``(splits, per)`` of the split route: each slot's ``pmax``
    page-table entries cut into ``splits`` runs of ``per`` (the last
    shorter), so that ``slots x heads x splits`` blocks make about
    :data:`SPLIT_BLOCKS_PER_SM` per SM, with no split empty at ``pmax``
    and none longer than :data:`SPLIT_MAX_PER`. A pure function of the
    shapes and the SM count: the lengths are never read on the host."""
    if pmax < 1:
        return 1, 1
    want = -(-SPLIT_BLOCKS_PER_SM * sms // max(1, slots * heads))
    want = min(pmax, max(want, -(-pmax // SPLIT_MAX_PER), 1))
    per = -(-pmax // want)
    return -(-pmax // per), per


def paged_attention_plain(q, k_pages, v_pages, page_table, lengths, scale,
                          k_scale=None, v_scale=None):
    """Gather-and-mask reference. q ``[S, H, hd]``; pools
    ``[N, H, ps, hd]``; page_table ``[S, Pmax]`` (in range everywhere);
    lengths ``[S]``; k/v_scale ``[N, ps]`` for int8 pools. A length-0
    slot gives exactly 0."""
    s_slots, h, hd = q.shape
    page_size = k_pages.shape[2]
    p_max = page_table.shape[1]
    t = p_max * page_size
    pt = page_table.long()
    kg = k_pages[pt].float()                   # [S, Pmax, H, ps, hd]
    vg = v_pages[pt].float()
    if k_scale is not None:
        kg = kg * k_scale[pt][:, :, None, :, None]
        vg = vg * v_scale[pt][:, :, None, :, None]
    k = kg.movedim(2, 1).reshape(s_slots, h, t, hd)
    v = vg.movedim(2, 1).reshape(s_slots, h, t, hd)
    scores = torch.einsum("shd,shtd->sht", q.float(), k) * scale
    valid = (torch.arange(t, device=q.device)[None, :]
             < lengths[:, None])[:, None, :]
    scores = torch.where(valid, scores, torch.full_like(scores, NEG_INF))
    m = scores.amax(dim=-1, keepdim=True)
    # mask p, not just scores: a length-0 slot keeps m at NEG_INF
    p = torch.where(valid, torch.exp(scores - m), torch.zeros_like(scores))
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("sht,shtd->shd", p, v)
    out = torch.where(l > 0, out / torch.clamp(l, min=1e-30),
                      torch.zeros_like(out))
    return out.to(q.dtype)


def _decode_cuda(q, k_pages, v_pages, page_table, lengths, scale,
                 k_scale, v_scale):
    """K7's op on CUDA tensors: one launch on the route
    :func:`decode_route` picks."""
    if q.dtype != torch.float32:
        raise TypeError(f"decode kernel: q must be float32, got {q.dtype}")
    code = core.dtype_code(k_pages,
                           (torch.float32, torch.bfloat16, torch.int8))
    if v_pages.dtype != k_pages.dtype:
        raise TypeError("decode kernel: k and v pools differ in dtype")
    quantized = code == core.I8
    if quantized != (k_scale is not None) or (k_scale is None) != (
            v_scale is None):
        raise ValueError("decode kernel: k_scale/v_scale go with int8 "
                         "pools and only with them")
    core.require_contiguous(q=q, k_pages=k_pages, v_pages=v_pages,
                            k_scale=k_scale, v_scale=v_scale)
    s_slots, h, hd = q.shape
    n, h2, ps, hd2 = k_pages.shape
    if (h2, hd2) != (h, hd) or v_pages.shape != k_pages.shape:
        raise ValueError(f"decode kernel: pools {tuple(k_pages.shape)} do "
                         f"not match q {tuple(q.shape)}")
    if quantized and (k_scale.dtype != torch.float32
                      or k_scale.shape != (n, ps)
                      or v_scale.shape != (n, ps)):
        raise ValueError(f"decode kernel: scales must be f32 [{n}, {ps}]")
    if page_table.shape[0] != s_slots or lengths.shape != (s_slots,):
        raise ValueError("decode kernel: page_table/lengths do not match "
                         f"{s_slots} slots")
    ptab = page_table.to(torch.int32).contiguous()
    lens = lengths.to(torch.int32).contiguous()
    out = torch.empty_like(q)
    if s_slots == 0 or h == 0:
        return out
    pmax = ptab.shape[1]
    if decode_route(hd) == "split":
        for name, t in (("k_pages", k_pages), ("v_pages", v_pages)):
            if t.data_ptr() % 16:
                raise ValueError(f"decode kernel: {name} does not start on "
                                 "16 bytes (the split route reads rows in "
                                 "vector loads)")
        sms = torch.cuda.get_device_properties(
            q.device).multi_processor_count
        splits, per = split_plan(s_slots, h, pmax, sms)
        part = tickets = None
        if splits > 1:
            part = torch.empty((s_slots, h, splits, hd + 2),
                               dtype=torch.float32, device=q.device)
            tickets = _tickets(q.device, s_slots * h)
        KERNEL(code, core.ptr(q), core.ptr(k_pages), core.ptr(v_pages),
               core.ptr(k_scale), core.ptr(v_scale), core.ptr(ptab),
               core.ptr(lens), core.ptr(out), core.ptr(part),
               core.ptr(tickets), s_slots, n, h, ps, hd, pmax, per, splits,
               float(scale), core.stream(q), route="split")
        del part             # enqueued: stream order protects the scratch
        return out
    smem = 4 * (hd + ps * (hd + 1) + ps * hd + ps + 32)
    if smem > core.MAX_SMEM:
        raise ValueError(f"decode kernel: page {ps}x{hd} needs {smem} bytes "
                         "of shared memory")
    KERNEL(code, core.ptr(q), core.ptr(k_pages), core.ptr(v_pages),
           core.ptr(k_scale), core.ptr(v_scale), core.ptr(ptab),
           core.ptr(lens), core.ptr(out), s_slots, n, h, ps, hd, pmax,
           float(scale), core.stream(q))
    return out


DECODE_OP = core.define_op(
    KERNEL, "(Tensor q, Tensor k_pages, Tensor v_pages, Tensor page_table, "
    "Tensor lengths, float scale, Tensor? k_scale, Tensor? v_scale) -> "
    "Tensor", _decode_cuda,
    lambda q, k_pages, v_pages, page_table, lengths, scale, k_scale,
    v_scale: torch.empty_like(q))


def paged_decode_kernel(q, k_pages, v_pages, page_table, lengths, scale,
                        k_scale=None, v_scale=None):
    """K7 on CUDA tensors, through its op -> ``[S, H, hd]`` f32. q is f32;
    pools are f32, bf16, or int8 with both scales."""
    return DECODE_OP(q, k_pages, v_pages, page_table, lengths, float(scale),
                     k_scale, v_scale)


def paged_decode_attention(q, k_pages, v_pages, page_table, lengths,
                           scale=None, k_scale=None, v_scale=None):
    """Single-query attention over a paged KV cache (ref:
    ``ops/attention.py:225``). q ``[S, H, hd]``; pools ``[N, H, ps, hd]``;
    page_table ``[S, Pmax]`` int32, in range everywhere; lengths ``[S]``
    (0 = inactive slot -> exactly-zero output); k/v_scale ``[N, ps]`` for
    int8 pools. K7 on CUDA tensors, the plain version on CPU tensors."""
    scale = float(scale) if scale is not None else 1.0 / math.sqrt(
        q.shape[-1])
    if core.on_card(q, k_pages, v_pages, page_table, lengths, k_scale,
                    v_scale):
        return paged_decode_kernel(q.contiguous(), k_pages, v_pages,
                                   page_table, lengths, scale, k_scale,
                                   v_scale)
    return paged_attention_plain(q, k_pages, v_pages, page_table, lengths,
                                 scale, k_scale, v_scale)
