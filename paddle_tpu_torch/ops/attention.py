"""Attention ops and the paged KV cache (ref: ``paddle_tpu/ops/attention.py``).

The paged layout is the reference's: one pool of fixed-size pages per
layer, ``{"k", "v"}`` of ``[num_pages, H, page_size, hd]``, plus per-slot
page tables ``[slots, Pmax]`` int32 and token counts ``[slots]``. An int8
pool adds ``{"k_scale", "v_scale"}`` f32 ``[num_pages, page_size]``: one
symmetric absmax scale per (page, token row), shared across heads and
head_dim.

Unlike the reference, which donates the pools to each jitted step and
gets new ones back, the port updates the pools **in place**:
:func:`paged_write` writes into the tensors of the dict it is given and
returns that same dict.
"""

import math

import torch

from paddle_tpu_torch.core.device import resolve_device
from paddle_tpu_torch.core.enforce import EnforceError, enforce
from paddle_tpu_torch.core.registry import register_op
from paddle_tpu_torch.ops.cuda.decode_attention import (  # noqa: F401
    NEG_INF, paged_decode_attention)
from paddle_tpu_torch.ops.cuda.flash_attention import flash_attention
from paddle_tpu_torch.ops.nn import matmul


def dropout_mask(shape, rate, gen, device):
    """Keep-mask of inverted dropout drawn from the explicit generator
    ``gen`` (the reference draws from an explicit PRNG key; the port never
    draws from torch's global generator). Raises without one."""
    if gen is None:
        raise EnforceError(
            f"dropout (rate {rate}) in training needs an explicit "
            "torch.Generator")
    return torch.rand(shape, generator=gen, device=device) < 1.0 - rate


def scaled_dot_product_attention(q, k, v, mask=None, scale=None,
                                 causal=False, dropout_rate=0.0,
                                 training=False, dropout_gen=None):
    """q, k, v ``[B, H, T, D]`` (or ``[B, T, D]``); mask broadcastable to
    ``[B, H, Tq, Tk]``, True/1 = keep. Materializes the score matrix;
    causal masking is bottom-right aligned; a fully masked row gives
    exactly 0 (ref: ``ops/attention.py:22``). Attention dropout draws its
    mask from ``dropout_gen``."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    scores = torch.einsum("...qd,...kd->...qk", q, k) * scale
    keep = None
    if causal:
        tq, tk = scores.shape[-2], scores.shape[-1]
        keep = torch.ones((tq, tk), dtype=torch.bool,
                          device=q.device).tril(diagonal=tk - tq)
    if mask is not None:
        keep = mask.bool() if keep is None else keep & mask.bool()
    if keep is not None:
        scores = torch.where(keep, scores, torch.full_like(scores, -1e9))
    probs = torch.softmax(scores, dim=-1)
    if keep is not None:
        any_keep = torch.broadcast_to(keep, scores.shape).any(
            dim=-1, keepdim=True)
        probs = torch.where(any_keep, probs, torch.zeros_like(probs))
    if dropout_rate > 0.0 and training:
        keep = dropout_mask(probs.shape, dropout_rate, dropout_gen,
                            probs.device)
        probs = torch.where(keep, probs / (1.0 - dropout_rate),
                            torch.zeros_like(probs))
    return torch.einsum("...qk,...kd->...qd", probs, v)


def _as_key_padding_mask(mask, batch, tk):
    """Reduce a broadcastable attention mask to key-padding form ``[B, Tk]``
    bool when its per-head and per-query dims are 1 (ref:
    ``ops/attention.py:56``): ``[B, 1, 1, Tk]`` -> ``[B, Tk]``,
    ``[1, 1, Tk]`` and ``[1, Tk]`` broadcast over the batch. A 2-D
    ``[B, Tk]`` mask broadcasts per query in the dense path, so it is not
    reduced; neither is a mask of another ``Tk``. Returns None when the
    mask is not of key-padding form."""
    if mask is None:
        return None
    m = mask
    if m.ndim == 4 and m.shape[1] == 1 and m.shape[2] == 1:
        m = m[:, 0, 0, :]
    elif m.ndim == 3 and m.shape[0] == 1 and m.shape[1] == 1:
        # a 3-D mask's leading dim broadcasts against the head axis in the
        # dense path, so only the fully degenerate [1, 1, Tk] is unambiguous
        m = m[:, 0, :]
    elif not (m.ndim == 2 and m.shape[0] == 1):
        return None
    if m.shape[-1] != tk:
        return None
    if m.shape[0] == 1 and batch > 1:
        m = m.expand(batch, tk)
    elif m.shape[0] != batch:
        return None
    return m.bool()


def multihead_attention(x, wq, wk, wv, wo, bq=None, bk=None, bv=None,
                        bo=None, num_heads=8, mask=None, causal=False,
                        kv=None, dropout_rate=0.0, training=False,
                        use_flash=False, dropout_gen=None):
    """Multi-head attention forward (ref: ``ops/attention.py:266``). x
    ``[B, Tq, E]``; w* ``[E, E]`` stored ``[in, out]`` for ``x @ W``;
    the biases are optional. Keys and values are projected from ``kv``
    ``[B, Tk, E]`` when given (cross-attention, Tk may differ from Tq),
    else from x. Products promote as jnp does (:func:`ops.nn.matmul`):
    f32 activations with bf16 weights give f32. With ``use_flash`` and no
    attention dropout, a call without a mask or with a mask of key-padding
    form rides flash attention (K2 forward, K3 backward on the card) with
    that mask as ``kv_mask``; any other mask takes the dense path."""
    b, t, e = x.shape
    hd = e // num_heads
    kv = x if kv is None else kv

    def proj(inp, w, bias):
        out = matmul(inp, w)
        if bias is not None:
            out = out + bias
        return out.reshape(b, -1, num_heads, hd).transpose(1, 2)

    q, k, v = proj(x, wq, bq), proj(kv, wk, bk), proj(kv, wv, bv)
    no_dropout = dropout_rate == 0.0 or not training
    kv_mask = _as_key_padding_mask(mask, b, k.shape[2])
    if use_flash and (mask is None or kv_mask is not None) and no_dropout:
        ctx = flash_attention(q, k, v, causal=causal, kv_mask=kv_mask)
    else:
        ctx = scaled_dot_product_attention(q, k, v, mask=mask,
                                           causal=causal,
                                           dropout_rate=dropout_rate,
                                           training=training,
                                           dropout_gen=dropout_gen)
    out = matmul(ctx.transpose(1, 2).reshape(b, t, e), wo)
    return out if bo is None else out + bo



# --- the registered forms, with the reference's signatures ----------------
# A ProgramDesc passes inputs by position and attrs by name, so each name
# takes the reference's arguments; the reference's ``dropout_key`` is the
# port's explicit generator (dropout applies when one is given, as the
# reference's applies when a key is).

@register_op("scaled_dot_product_attention")
def scaled_dot_product_attention_op(q, k, v, mask=None, scale=None,
                                    causal=False, dropout_rate=0.0,
                                    dropout_key=None):
    """ref: ``ops/attention.py:22``; ``dropout_key`` a torch.Generator."""
    return scaled_dot_product_attention(
        q, k, v, mask=mask, scale=scale, causal=causal,
        dropout_rate=dropout_rate, training=dropout_key is not None,
        dropout_gen=dropout_key)


@register_op("multihead_attention")
def multihead_attention_op(x, wq, wk, wv, wo, bq=None, bk=None, bv=None,
                           bo=None, num_heads=8, mask=None, causal=False,
                           kv=None, dropout_rate=0.0, dropout_key=None,
                           use_flash=False, seq_axis=None):
    """ref: ``ops/attention.py:266``; ``dropout_key`` a torch.Generator.
    With ``use_flash`` it rides K2/K3 on the card. ``seq_axis`` (ring
    attention over a device mesh's sequence axis) has no mesh to run on
    in the port and must be None."""
    enforce(seq_axis is None,
            "multihead_attention: seq_axis (ring attention) needs a mesh")
    return multihead_attention(
        x, wq, wk, wv, wo, bq, bk, bv, bo, num_heads=num_heads, mask=mask,
        causal=causal, kv=kv, dropout_rate=dropout_rate,
        training=dropout_key is not None, use_flash=use_flash,
        dropout_gen=dropout_key)


register_op("paged_decode_attention")(paged_decode_attention)


# --- paged KV cache --------------------------------------------------------

def quantized_pool(pool):
    """True iff ``pool`` is an int8 pool carrying per-row scales."""
    return "k_scale" in pool


def quantize_kv_rows(x):
    """Symmetric per-token-row int8 quantization. x ``[T, H, hd]`` ->
    (int8 ``[T, H, hd]``, f32 scale ``[T]``), scale = absmax/127. An
    all-zero row stores scale 0 and dequantizes to exactly 0."""
    xf = x.float()
    scale = xf.abs().amax(dim=(1, 2)) / 127.0
    q = torch.clamp(torch.round(xf / torch.clamp(scale, min=1e-30)[:, None,
                                                                  None]),
                    -127.0, 127.0).to(torch.int8)
    return q, scale


def dequantize_pages(pages, scales):
    """Dequantize gathered pages: ``[..., H, ps, hd]`` int8 with scales
    ``[..., ps]`` aligned on the leading dims -> f32."""
    return pages.float() * scales[..., None, :, None]


def init_page_pool(num_pages, num_heads, page_size, head_dim,
                   dtype=torch.float32, kv_dtype=None, device="cuda"):
    """One layer's KV page pool ``{"k", "v"}`` ``[num_pages, H, page_size,
    hd]`` of zeros on ``device``; ``kv_dtype=torch.int8`` stores int8
    values and adds ``{"k_scale", "v_scale"}`` f32 ``[num_pages,
    page_size]``."""
    dev = resolve_device(device)
    shape = (num_pages, num_heads, page_size, head_dim)
    if kv_dtype is None or kv_dtype == dtype:
        return {"k": torch.zeros(shape, dtype=dtype, device=dev),
                "v": torch.zeros(shape, dtype=dtype, device=dev)}
    if kv_dtype != torch.int8:
        raise ValueError(f"unsupported kv_dtype {kv_dtype!r} "
                         "(supported: torch.int8, or None for the pool "
                         "dtype)")
    sshape = (num_pages, page_size)
    return {"k": torch.zeros(shape, dtype=torch.int8, device=dev),
            "v": torch.zeros(shape, dtype=torch.int8, device=dev),
            "k_scale": torch.zeros(sshape, dtype=torch.float32, device=dev),
            "v_scale": torch.zeros(sshape, dtype=torch.float32, device=dev)}


def _drop_redirect(page_ids, offsets, num_pages):
    """Destinations for a scatter that DROPS rows whose page id lies
    outside ``[0, num_pages)``, as the reference's ``mode="drop"`` does.
    PyTorch has no drop mode, and filtering the rows would need the
    device's answer on the host. So every dropped row is sent to the
    destination of the first kept row instead, and writes that row's
    value there (a duplicate index carrying the identical value is
    harmless). With no kept row at all, every row goes to ``(0, 0)`` and
    rewrites the value already there. Returns ``(src [T], pages [T],
    offsets [T], any_kept)``: row ``i`` writes the value of row
    ``src[i]``."""
    keep = (page_ids >= 0) & (page_ids < num_pages)
    first = torch.argmax(keep.to(torch.int32))
    # not keep[first]: a 0-d index tensor is read on the host
    any_kept = keep.any()
    idx = torch.arange(page_ids.shape[0], device=page_ids.device)
    src = torch.where(keep, idx, first)
    pages = torch.where(any_kept, page_ids[src], torch.zeros_like(page_ids))
    offs = torch.where(any_kept, offsets[src], torch.zeros_like(offsets))
    return src, pages.long(), offs.long(), any_kept


def paged_write(pool, k_t, v_t, page_ids, offsets):
    """Scatter per-token K/V into the pool's pages **in place**. k_t/v_t
    ``[T, H, hd]``; page_ids/offsets ``[T]``. A page id outside
    ``[0, num_pages)`` drops its row (the engine sends inactive slots and
    pad positions to page ``num_pages`` on purpose). On an int8 pool each
    row is quantized on the way in and its scale written beside it.
    Returns ``pool``."""
    if k_t.shape[0] == 0:
        return pool
    num_pages = pool["k"].shape[0]
    src, pages, offs, any_kept = _drop_redirect(page_ids, offsets,
                                                num_pages)

    def put(name, rows):
        dst = pool[name]
        idx = (pages, slice(None), offs) if dst.ndim == 4 else (pages, offs)
        dst[idx] = torch.where(any_kept, rows[src].to(dst.dtype), dst[idx])

    if quantized_pool(pool):
        k_q, k_s = quantize_kv_rows(k_t)
        v_q, v_s = quantize_kv_rows(v_t)
        put("k", k_q)
        put("v", v_q)
        put("k_scale", k_s)
        put("v_scale", v_s)
    else:
        put("k", k_t)
        put("v", v_t)
    return pool



def copy_pages(pool, src_ids, dst_ids):
    """Copy whole pages ``src -> dst`` within one layer's pool **in
    place** (ref: ``ops/attention.py:177``): the serving engine's
    copy-on-write primitive, which duplicates a prefix-cache page into a
    private one before a slot writes into it. src_ids/dst_ids ``[M]``
    int, every src in range. A dst outside ``[0, num_pages)`` drops its
    copy, as :func:`paged_write` drops a row. Every entry of the pool is
    copied, so an int8 pool's ``k_scale``/``v_scale`` travel with their
    pages bit-exact (no requantization). All sources are read before any
    destination is written. Returns ``pool``."""
    if src_ids.shape[0] == 0:
        return pool
    num_pages = pool["k"].shape[0]
    rows, pages, _, any_kept = _drop_redirect(
        dst_ids, torch.zeros_like(dst_ids), num_pages)
    src = src_ids.long()[rows]
    for arr in pool.values():
        arr[pages] = torch.where(any_kept, arr[src], arr[pages])
    return pool
