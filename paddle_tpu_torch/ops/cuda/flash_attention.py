"""K2: flash-attention forward — the CUDA kernel and its plain PyTorch
version.

Replaces ``paddle_tpu/ops/pallas/flash_attention.py:64 _fa_kernel``
(launcher ``_flash_attention_fwd_tpu`` :112, entry ``flash_attention``
:510); forward only. Source: ``paddle_tpu_torch/csrc/flash_attention.cu``.
The TPU kernel's sequential kv grid axis, which carries (m, l, acc) in
VMEM, becomes a loop inside one block per (batch*head, 64-row query
tile). Both products run in the kernel's own body, in f32, so at prefill
it is bound by f32 operations; the causal block skip halves them.

The plain version is the reference's ``chunked_attention`` (:379): the
same online softmax over kv chunks, with the same masking rules
(bottom-right causal offset ``tk - tq``, key-padding mask, fully masked
rows exactly 0).
"""

import math

import torch

from paddle_tpu_torch.ops.cuda import core

KERNEL = core.register(
    "flash_attention", "ptt_flash_attention",
    [core.I32] + [core.VP] * 6 + [core.I32] * 5
    + [core.F32_ARG, core.I32, core.VP],
    replaces="paddle_tpu/ops/pallas/flash_attention.py:64",
    source="paddle_tpu_torch/csrc/flash_attention.cu")

NEG_INF = -1e30
#: the reference's default kv block (flag flash_block_k), which is also
#: the chunk of its CPU path
CHUNK = 512
HEAD_DIMS = (16, 32, 64, 128)


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


def flash_attention_kernel(q, k, v, scale, causal=False, kv_mask=None):
    """Launch K2 on CUDA tensors -> ``(out [B, H, Tq, D], lse
    [B, H, Tq] f32)``."""
    code = core.dtype_code(q, (torch.float32, torch.bfloat16))
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("flash kernel: q, k and v must share one dtype")
    core.require_contiguous(q=q, k=k, v=v)
    b, h, tq, d = q.shape
    tk = k.shape[2]
    if d not in HEAD_DIMS:
        raise ValueError(f"flash kernel: head dim {d} not in {HEAD_DIMS}")
    if k.shape != (b, h, tk, d) or v.shape != k.shape:
        raise ValueError(f"flash kernel: k/v {tuple(k.shape)} "
                         f"{tuple(v.shape)} do not match q {tuple(q.shape)}")
    mask = None
    if kv_mask is not None:
        if kv_mask.shape != (b, tk):
            raise ValueError(f"kv_mask must be [{b}, {tk}]")
        mask = kv_mask.to(torch.int32).contiguous()
    out = torch.empty_like(q)
    lse = torch.empty((b, h, tq), dtype=torch.float32, device=q.device)
    if q.numel() == 0:
        return out, lse
    KERNEL(code, core.ptr(q), core.ptr(k), core.ptr(v), core.ptr(mask),
           core.ptr(out), core.ptr(lse), b, h, tq, tk, d, float(scale),
           int(bool(causal)), core.stream(q))
    return out, lse


def flash_attention(q, k, v, scale=None, causal=False, kv_mask=None):
    """Memory-efficient attention. q, k, v ``[B, H, T, D]``; kv_mask
    ``[B, Tk]`` (True = attend). K2 on CUDA tensors, the chunked plain
    version on CPU tensors."""
    scale = float(scale) if scale is not None else 1.0 / math.sqrt(
        q.shape[-1])
    if core.on_card(q, k, v, kv_mask):
        return flash_attention_kernel(q.contiguous(), k.contiguous(),
                                      v.contiguous(), scale, causal,
                                      kv_mask)[0]
    return chunked_attention(q, k, v, scale=scale, causal=causal,
                             kv_mask=kv_mask)
