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
    replaces="paddle_tpu/ops/pallas/xent.py:49", source=_SRC)
KERNEL_DH = core.register(
    "xent_bwd_dh", "ptt_xent_bwd_dh",
    [core.I32] + [core.VP] * 8 + [core.I32] * 5
    + [core.F32_ARG, core.F32_ARG, core.VP],
    replaces="paddle_tpu/ops/pallas/xent.py:178", source=_SRC)
KERNEL_DWB = core.register(
    "xent_bwd_dwb", "ptt_xent_bwd_dwb",
    [core.I32] + [core.VP] * 10 + [core.I32] * 5
    + [core.F32_ARG, core.F32_ARG, core.VP],
    replaces="paddle_tpu/ops/pallas/xent.py:200", source=_SRC)

#: vocab chunk of the plain versions (the reference's xent_chunk flag)
CHUNK = 8192
#: resident rows per block and streamed rows per tile in csrc/xent.cu
RES_ROWS, STREAM_ROWS = 32, 64
#: the largest hidden size the kernels take (12 accumulator columns of
#: 64 per thread)
MAX_HIDDEN = 768


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
    if hid > MAX_HIDDEN:
        raise ValueError(f"{what}: hidden size {hid} > {MAX_HIDDEN}")
    if labels.shape != (n,):
        raise ValueError(f"{what}: labels must be [{n}]")
    if b is not None and (b.shape != (v,) or b.dtype != torch.float32):
        raise ValueError(f"{what}: bias must be [{v}] f32")
    core.require_contiguous(h=h, w=w, b=b)
    return code, n, v, hid


def _split_plan(resident, streamed, blocks_wanted):
    """``(splits, tiles_per_split)`` of the streamed axis: enough splits
    that ``resident tiles x splits`` reaches ``blocks_wanted``."""
    res_tiles = -(-resident // RES_ROWS)
    tiles = -(-streamed // STREAM_ROWS)
    want = max(1, -(-blocks_wanted // res_tiles))
    per = -(-tiles // min(tiles, want))
    return -(-tiles // per), per


def _sms(t):
    return torch.cuda.get_device_properties(t.device).multi_processor_count


def xent_stats_kernel(h, w, b, labels):
    """Launch K5 on CUDA tensors; same outputs as the plain version."""
    code, n, v, hid = _check(h, w, b, labels, "xent_stats kernel")
    out = torch.empty((4, n), dtype=torch.float32, device=h.device)
    if n == 0 or v == 0:
        return tuple(out)
    lbl = labels.to(torch.int32).contiguous()
    # two blocks fit on an SM: aim for two waves of them
    nsplit, per = _split_plan(n, v, 4 * _sms(h))
    part = (torch.empty((nsplit, 4, n), dtype=torch.float32,
                        device=h.device) if nsplit > 1 else None)
    KERNEL_STATS(code, core.ptr(h), core.ptr(w), core.ptr(b), core.ptr(lbl),
                 core.ptr(out), core.ptr(part), n, v, hid, nsplit, per,
                 core.stream(h))
    return tuple(out)


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


def _bwd_setup(h, w, b, labels, logz, g, what):
    """``(code, n, v, hid, ptrs, operands)``. The caller holds
    ``operands`` (labels, logz and g converted for the kernel) until the
    launch: a converted copy freed before its kernel is enqueued goes back
    to the caching allocator, and the next allocation on the stream (the
    kernel's own output) may be handed the same memory."""
    code, n, v, hid = _check(h, w, b, labels, what)
    operands = (labels.to(torch.int32).contiguous(),
                logz.float().contiguous(), g.float().contiguous())
    ptrs = (core.ptr(h), core.ptr(w), core.ptr(b),
            *(core.ptr(t) for t in operands))
    return code, n, v, hid, ptrs, operands


def xent_bwd_dh_kernel(h, w, b, labels, logz, g, sn, sp):
    """Launch K6's dh kernel on CUDA tensors -> dh ``[N, H]`` f32."""
    code, n, v, hid, ptrs, operands = _bwd_setup(h, w, b, labels, logz, g,
                                                 "xent_bwd_dh kernel")
    dh = torch.empty((n, hid), dtype=torch.float32, device=h.device)
    if n == 0 or v == 0:
        return dh.zero_()
    # one block fits on an SM (its accumulator takes the registers)
    nsplit, per = _split_plan(n, v, _sms(h))
    part = (torch.empty((nsplit, n, hid), dtype=torch.float32,
                        device=h.device) if nsplit > 1 else None)
    KERNEL_DH(code, *ptrs, core.ptr(dh), core.ptr(part), n, v, hid, nsplit,
              per, float(sn), float(sp), core.stream(h))
    del operands                     # enqueued: stream order protects them
    return dh


def xent_bwd_dwb_kernel(h, w, b, labels, logz, g, sn, sp):
    """Launch K6's dw/db kernel on CUDA tensors -> ``(dw [V, H], db
    [V])`` f32."""
    code, n, v, hid, ptrs, operands = _bwd_setup(h, w, b, labels, logz, g,
                                                 "xent_bwd_dwb kernel")
    dw = torch.empty((v, hid), dtype=torch.float32, device=h.device)
    db = torch.empty(v, dtype=torch.float32, device=h.device)
    if n == 0 or v == 0:
        return dw.zero_(), db.zero_()
    nsplit, per = _split_plan(v, n, _sms(h))
    part, db_part = None, None
    if nsplit > 1:
        part = torch.empty((nsplit, v, hid), dtype=torch.float32,
                           device=h.device)
        db_part = torch.empty((nsplit, v), dtype=torch.float32,
                              device=h.device)
    KERNEL_DWB(code, *ptrs, core.ptr(dw), core.ptr(db), core.ptr(part),
               core.ptr(db_part), n, v, hid, nsplit, per, float(sn),
               float(sp), core.stream(h))
    del operands                     # enqueued: stream order protects them
    return dw, db


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
