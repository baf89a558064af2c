"""Layers of the slice (ref: ``paddle_tpu/nn/layers.py``).

Weights keep the reference's layout: a projection stores ``[in, out]``
and computes ``x @ W``, a convolution stores OIHW (NCHW) or HWIO (NHWC),
so the weight bridge (``paddle_tpu_torch/bridge.py``)
copies arrays without transposing them. Parameter names match the
reference's param-tree keys (``weight``, ``bias``, ``scale``, ``wq`` ...),
and batch norm's buffers its ``state`` keys (``mean``, ``variance``).

Weights are created on the CPU from a ``torch.Generator`` and moved by the
owning model. After ``quant.quantize_weights_int8`` a layer holds the
reference's weight-only int8 pair in place of a weight (``weight_q`` int8
and ``weight_scale``, or ``wq_q`` / ``wq_scale`` ...), and ``Linear``,
``Embedding``, :func:`tied_vocab_head` and attention's projections read it
as the reference does (``nn/layers.py:26-33``, ``:51-56``, ``:277-301``,
``:502-521``).
"""

import torch
from torch import nn

from paddle_tpu_torch import initializer as I
from paddle_tpu_torch.core.ragged import RaggedBatch
from paddle_tpu_torch.ops import activations as A
from paddle_tpu_torch.ops import attention as att
from paddle_tpu_torch.ops import nn as F
from paddle_tpu_torch.ops import rnn as R
from paddle_tpu_torch.ops import sequence as S
from paddle_tpu_torch.ops.cuda.layer_norm import add_layer_norm_fused
from paddle_tpu_torch.ops.cuda.mlp import fused_mlp


def _xavier(shape, gen, dtype):
    return nn.Parameter(I.xavier()(shape, gen, dtype))


def _act(name, x):
    return x if name is None else getattr(A, name)(x)


def is_int8(module, name="weight"):
    """True when ``module``'s ``name`` is held as weight-only int8
    (``<name>_q`` and ``<name>_scale``)."""
    return f"{name}_q" in module._parameters


def _int8_dot(x, q, scale, rhs_axis=0):
    """``x`` contracted over its last axis with the int8 kernel ``q``'s
    ``rhs_axis``, the per-channel scale applied to the output (ref:
    ``nn/layers.py:26``): exact, since the scale's axis is the one not
    contracted. The reference's ``dot_general`` reads int8 in a mixed-type
    dot; torch has none, so the kernel is cast to ``x``'s dtype first
    (exact: every int8 value is a bf16 and an f32)."""
    w = q.to(x.dtype)
    return (x @ (w if rhs_axis == 0 else w.T)) * scale.to(x.dtype)


class Linear(nn.Module):
    """ref: ``nn/layers.py:37`` — ``act(x @ weight + bias)``, weight
    ``[in, out]`` drawn by ``weight_init`` (xavier by default), the bias
    by ``bias_init`` (zeros by default); ``bias=False`` has no bias
    parameter, ``act`` names an activation of
    ``ops/activations.py`` (``"gelu"``, ``"relu"``, ``"sigmoid"``)."""

    def __init__(self, in_features, out_features, bias=True, act=None,
                 gen=None, dtype=torch.float32, weight_init=None,
                 bias_init=None):
        super().__init__()
        self.act = act
        self.weight = nn.Parameter((weight_init or I.xavier())(
            (in_features, out_features), gen, dtype))
        self.bias = (nn.Parameter((bias_init or I.zeros())(
            (out_features,), gen, dtype)) if bias else None)

    def forward(self, x):
        if is_int8(self):
            out = _int8_dot(x, self.weight_q, self.weight_scale)
        else:
            out = F.matmul(x, self.weight)
        if self.bias is not None:
            out = out + self.bias
        return _act(self.act, out)


def fused_ffn(fc1, fc2, x, act="gelu"):
    """``fc2(gelu(fc1(x)))`` through the fused MLP (K4 on the card): the
    ``[rows, intermediate]`` activation never reaches device memory
    (ref: ``nn/layers.py:63``). The reference's dispatch rule keeps the
    unfused ``fc2(act(fc1(x)))`` when either layer is weight-only int8
    (its int8 dot is a kernel of its own) or carries an activation of its
    own; that is which function the call computes, not a fallback."""
    if (is_int8(fc1) or is_int8(fc2) or fc1.act is not None
            or fc2.act is not None):
        return fc2(_act(act, fc1(x)))
    if act != "gelu":
        raise NotImplementedError(f"fused_ffn: act={act!r} (the port has "
                                  "the exact-gelu MLP only)")
    return fused_mlp(x, fc1.weight, fc1.bias, fc2.weight, fc2.bias)


class LayerNorm(nn.Module):
    """ref: ``nn/layers.py:208``. ``scale=False`` / ``shift=False`` leave
    out the ``scale`` / ``bias`` parameter (the kernels then normalize
    with ones and zeros)."""

    def __init__(self, normalized_shape, epsilon=1e-5, scale=True,
                 shift=True, dtype=torch.float32):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = (normalized_shape,)
        self.shape = tuple(normalized_shape)
        self.epsilon = epsilon
        n = 1
        for d in self.shape:
            n *= d
        self.scale = (nn.Parameter(torch.ones(n, dtype=dtype)) if scale
                      else None)
        self.bias = (nn.Parameter(torch.zeros(n, dtype=dtype)) if shift
                     else None)

    def forward(self, x, residual=None):
        """``ln(x)`` (K1 on the card); with ``residual``, ``ln(x +
        residual)`` in one fused pass (K8 on the card), the transformer's
        post-norm residual."""
        begin = x.ndim - len(self.shape)
        if residual is not None:
            return add_layer_norm_fused(x, residual, self.scale, self.bias,
                                        begin_norm_axis=begin,
                                        epsilon=self.epsilon)
        return F.layer_norm(x, self.scale, self.bias, begin_norm_axis=begin,
                            epsilon=self.epsilon)


class Conv2D(nn.Module):
    """ref: ``nn/layers.py:79`` — ``act(conv2d(x, weight) + bias)``. The
    weight is stored as the reference stores it: OIHW for NCHW, HWIO for
    NHWC (drawn on the OIHW view and transposed, so the initializer's fan
    is the OIHW one either way); ``bias`` is zeros."""

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, bias=True, act=None,
                 weight_init=None, gen=None, dtype=torch.float32,
                 data_format="NCHW"):
        super().__init__()
        k = ((kernel_size, kernel_size) if isinstance(kernel_size, int)
             else tuple(kernel_size))
        self.stride, self.padding, self.dilation, self.groups = \
            stride, padding, dilation, groups
        self.act = act
        self.data_format = data_format
        w = (weight_init or I.msra())(
            (out_channels, in_channels // groups) + k, gen, dtype)
        if data_format == "NHWC":
            w = w.permute(2, 3, 1, 0).contiguous()
        self.weight = nn.Parameter(w)
        self.bias = (nn.Parameter(torch.zeros(out_channels, dtype=dtype))
                     if bias else None)

    def forward(self, x):
        out = F.conv2d(x, self.weight, self.bias, self.stride, self.padding,
                       self.dilation, self.groups,
                       data_format=self.data_format)
        return _act(self.act, out)


class BatchNorm(nn.Module):
    """ref: ``nn/layers.py:147`` — parameters ``scale`` (ones) and
    ``bias`` (zeros); the running statistics ``mean`` (zeros) and
    ``variance`` (ones) are f32 buffers, the reference's ``state``
    collection. In training mode (``model.train()``, the reference's
    ``apply(training=True)``) each call normalizes with the batch's
    statistics and writes the updated running ones into the buffers in
    place; in eval mode it normalizes with the buffers."""

    def __init__(self, num_channels, momentum=0.9, epsilon=1e-5, act=None,
                 data_format="NCHW", dtype=torch.float32):
        super().__init__()
        self.momentum, self.epsilon, self.act = momentum, epsilon, act
        self.data_format = data_format
        self.scale = nn.Parameter(torch.ones(num_channels, dtype=dtype))
        self.bias = nn.Parameter(torch.zeros(num_channels, dtype=dtype))
        self.register_buffer("mean", torch.zeros(num_channels))
        self.register_buffer("variance", torch.ones(num_channels))

    def forward(self, x):
        out, new_mean, new_var = F.batch_norm(
            x, self.scale, self.bias, self.mean, self.variance, self.epsilon,
            self.momentum, training=self.training,
            data_format=self.data_format)
        if self.training:
            with torch.no_grad():
                self.mean.copy_(new_mean)
                self.variance.copy_(new_var)
        return _act(self.act, out)


class Pool2D(nn.Module):
    """ref: ``nn/layers.py:319`` — :func:`ops.nn.pool2d` over NCHW."""

    def __init__(self, pool_size=2, pool_type="max", pool_stride=None,
                 pool_padding=0, global_pooling=False):
        super().__init__()
        self.args = (pool_size, pool_type, pool_stride, pool_padding,
                     global_pooling)

    def forward(self, x):
        ps, pt, st, pd, gp = self.args
        return F.pool2d(x, ps, pt, st, pd, global_pooling=gp)


class Embedding(nn.Module):
    """ref: ``nn/layers.py:266`` — table ``[num_embeddings, dim]`` drawn by
    ``weight_init`` (N(0, 0.02) by default); ids equal to ``padding_idx``
    look up zeros."""

    def __init__(self, num_embeddings, embedding_dim, padding_idx=None,
                 weight_init=None, gen=None, dtype=torch.float32):
        super().__init__()
        self.padding_idx = padding_idx
        self.weight = nn.Parameter((weight_init or I.normal(0.0, 0.02))(
            (num_embeddings, embedding_dim), gen, dtype))

    def forward(self, ids):
        if is_int8(self):
            # int8 table, per-row scale: gather the int8 rows, dequantize
            # the gathered rows only; ids lose lookup_table's trailing 1
            # once, so the row and the scale gathers index alike (ref:
            # nn/layers.py:277)
            idx = (ids.squeeze(-1) if ids.ndim > 1 and ids.shape[-1] == 1
                   else ids)
            rows = F.lookup_table(idx, self.weight_q, self.padding_idx)
            s = self.weight_scale
            return rows.to(s.dtype) * s[idx.long()][..., None]
        return F.lookup_table(ids, self.weight, self.padding_idx)


def tied_vocab_head(emb, x):
    """Weight-tied vocab projection ``x @ W.T`` (ref:
    ``nn/layers.py:292``); over an int8 table the row scale lands on the
    logit axis, ``(x @ q.T) * s``."""
    if is_int8(emb):
        return _int8_dot(x, emb.weight_q, emb.weight_scale, rhs_axis=1)
    return x @ emb.weight.T


class Dropout(nn.Module):
    """ref: ``nn/layers.py:304`` — the reference's two modes:
    ``upscale_in_train`` (inverted dropout in training, identity
    otherwise) and ``downgrade_in_infer`` (the mask alone in training,
    ``x * (1 - rate)`` otherwise). The mask is drawn from the explicit
    ``torch.Generator`` ``gen`` (the reference's ``rngs={"dropout":
    key}``); training with a nonzero rate and no generator raises."""

    def __init__(self, rate=0.5, gen=None, mode="upscale_in_train"):
        super().__init__()
        self.rate = rate
        self.gen = gen
        self.mode = mode

    def forward(self, x):
        if not self.training or self.rate == 0.0:
            return F.dropout(x, None, self.rate, training=False,
                             mode=self.mode)
        keep = att.dropout_mask(x.shape, self.rate, self.gen, x.device)
        kept = x / (1.0 - self.rate) if self.mode == "upscale_in_train" \
            else x
        return torch.where(keep, kept, torch.zeros_like(x))


def _rnn_params(module, input_size, hidden_size, num_layers, ndir, gates,
                biases, gen, dtype):
    """The reference's per-layer, per-direction parameters
    ``w_ih_l{i}d{d}`` ``[in, gates * H]``, ``w_hh_l{i}d{d}`` ``[H, gates *
    H]`` (xavier) and the zero biases named by ``biases``."""
    for layer in range(num_layers):
        isz = input_size if layer == 0 else hidden_size * ndir
        for d in range(ndir):
            sfx = f"l{layer}d{d}"
            setattr(module, f"w_ih_{sfx}", _xavier(
                (isz, gates * hidden_size), gen, dtype))
            setattr(module, f"w_hh_{sfx}", _xavier(
                (hidden_size, gates * hidden_size), gen, dtype))
            for b in biases:
                setattr(module, f"{b}_{sfx}", nn.Parameter(
                    torch.zeros(gates * hidden_size, dtype=dtype)))


class LSTM(nn.Module):
    """Multi-layer LSTM, optionally bidirectional (ref: ``nn/layers.py:395``).
    ``forward(x [B, T, I], lengths=None)`` -> ``(out [B, T, H * ndir],
    (h, c))`` with h and c ``[layers * ndir, B, H]``."""

    def __init__(self, input_size, hidden_size, num_layers=1,
                 bidirectional=False, gen=None, dtype=torch.float32):
        super().__init__()
        self.hidden_size, self.num_layers = hidden_size, num_layers
        self.bidirectional = bidirectional
        _rnn_params(self, input_size, hidden_size, num_layers,
                    2 if bidirectional else 1, 4, ("b",), gen, dtype)

    def _dir(self, x, h0, c0, sfx, lengths, reverse=False):
        w = [getattr(self, f"{n}_{sfx}") for n in ("w_ih", "w_hh", "b")]
        return R.lstm(x, h0, c0, *w, lengths=lengths, reverse=reverse)

    def forward(self, x, lengths=None):
        b = x.shape[0]
        h0 = torch.zeros((b, self.hidden_size), dtype=x.dtype,
                         device=x.device)
        c0 = torch.zeros_like(h0)
        out, last_h, last_c = x, [], []
        for layer in range(self.num_layers):
            of, (hf, cf) = self._dir(out, h0, c0, f"l{layer}d0", lengths)
            if self.bidirectional:
                ob, (hb, cb) = self._dir(out, h0, c0, f"l{layer}d1", lengths,
                                         reverse=True)
                out = torch.cat([of, ob], -1)
                last_h += [hf, hb]
                last_c += [cf, cb]
            else:
                out = of
                last_h.append(hf)
                last_c.append(cf)
        return out, (torch.stack(last_h), torch.stack(last_c))


class GRU(nn.Module):
    """Multi-layer GRU, optionally bidirectional (ref: ``nn/layers.py:441``).
    ``forward(x [B, T, I], lengths=None)`` -> ``(out [B, T, H * ndir], h
    [layers * ndir, B, H])``."""

    def __init__(self, input_size, hidden_size, num_layers=1,
                 bidirectional=False, gen=None, dtype=torch.float32):
        super().__init__()
        self.hidden_size, self.num_layers = hidden_size, num_layers
        self.bidirectional = bidirectional
        _rnn_params(self, input_size, hidden_size, num_layers,
                    2 if bidirectional else 1, 3, ("b_ih", "b_hh"), gen,
                    dtype)

    def _dir(self, x, h0, sfx, lengths, reverse=False):
        w = [getattr(self, f"{n}_{sfx}")
             for n in ("w_ih", "w_hh", "b_ih", "b_hh")]
        return R.gru(x, h0, *w, lengths=lengths, reverse=reverse)

    def forward(self, x, lengths=None):
        h0 = torch.zeros((x.shape[0], self.hidden_size), dtype=x.dtype,
                         device=x.device)
        out, last = x, []
        for layer in range(self.num_layers):
            of, hf = self._dir(out, h0, f"l{layer}d0", lengths)
            if self.bidirectional:
                ob, hb = self._dir(out, h0, f"l{layer}d1", lengths,
                                   reverse=True)
                out = torch.cat([of, ob], -1)
                last += [hf, hb]
            else:
                out = of
                last.append(hf)
        return out, torch.stack(last)


class SequenceConv(nn.Module):
    """ref: ``nn/layers.py:837`` — context-window convolution over a
    :class:`~paddle_tpu_torch.core.ragged.RaggedBatch`
    (:func:`~paddle_tpu_torch.ops.sequence.sequence_conv`): ``filter``
    ``[context_length * in_dim, out_dim]`` (xavier), ``bias`` ``[out_dim]``
    (zeros) unless ``bias=False``, then ``act``."""

    def __init__(self, in_dim, out_dim, context_length=3, context_start=-1,
                 bias=True, act=None, gen=None, dtype=torch.float32):
        super().__init__()
        self.context_length = context_length
        self.context_start = context_start
        self.act = act
        self.filter = _xavier((context_length * in_dim, out_dim), gen, dtype)
        self.bias = (nn.Parameter(torch.zeros(out_dim, dtype=dtype))
                     if bias else None)

    def forward(self, rb, max_len=None):
        out = S.sequence_conv(rb, self.filter, self.context_start,
                              self.context_length, self.bias,
                              max_len=max_len)
        if self.act is not None:
            out = RaggedBatch(_act(self.act, out.values), out.row_lengths)
        return out


class RowConv(nn.Module):
    """ref: ``nn/layers.py:865`` — lookahead convolution over a
    :class:`~paddle_tpu_torch.core.ragged.RaggedBatch`
    (:func:`~paddle_tpu_torch.ops.sequence.row_conv`), ``filter``
    ``[future_context + 1, dim]`` (xavier)."""

    def __init__(self, dim, future_context=2, gen=None, dtype=torch.float32):
        super().__init__()
        self.filter = _xavier((future_context + 1, dim), gen, dtype)

    def forward(self, rb, max_len=None):
        return S.row_conv(rb, self.filter, max_len=max_len)


class MultiHeadAttention(nn.Module):
    """ref: ``nn/layers.py:488`` — q/k/v/o projections ``[E, E]``, the
    full forward (self- or cross-attention) and the paged serving
    methods. The paged methods update the pool **in place** and return
    it."""

    def __init__(self, embed_dim, num_heads, dropout=0.0, use_flash=False,
                 gen=None, dtype=torch.float32, dropout_gen=None):
        super().__init__()
        self.num_heads, self.dropout_rate = num_heads, dropout
        self.use_flash = use_flash
        self.dropout_gen = dropout_gen
        for n in ("q", "k", "v", "o"):
            setattr(self, f"w{n}", _xavier((embed_dim, embed_dim), gen,
                                           dtype))
            setattr(self, f"b{n}",
                    nn.Parameter(torch.zeros(embed_dim, dtype=dtype)))

    def _w(self, n):
        """Projection kernel ``w{n}``, dequantized when weight-only int8:
        the full forward runs once a sequence, so it materializes the
        float kernel; the cached and paged steps read int8 through
        :meth:`_project` (ref: ``nn/layers.py:502``)."""
        if is_int8(self, f"w{n}"):
            q, s = getattr(self, f"w{n}_q"), getattr(self, f"w{n}_scale")
            return q.to(s.dtype) * s[None, :]
        return getattr(self, f"w{n}")

    def _project(self, x, n):
        """``x @ w{n} + b{n}``, through the int8 dot when the kernel is
        weight-only int8 (ref: ``nn/layers.py:511``)."""
        if is_int8(self, f"w{n}"):
            out = _int8_dot(x, getattr(self, f"w{n}_q"),
                            getattr(self, f"w{n}_scale"))
        else:
            out = F.matmul(x, getattr(self, f"w{n}"))
        return out + getattr(self, f"b{n}")

    @property
    def embed_dim(self):
        return self.bq.shape[0]

    def forward(self, x, kv=None, mask=None, causal=False):
        """Self-attention over x, or cross-attention of x over ``kv``
        ``[B, Tk, E]`` (ref: ``nn/layers.py:566``)."""
        return att.multihead_attention(
            x, self._w("q"), self._w("k"), self._w("v"), self._w("o"),
            self.bq, self.bk, self.bv, self.bo, self.num_heads, mask=mask,
            causal=causal, kv=kv, dropout_rate=self.dropout_rate,
            training=self.training, use_flash=self.use_flash,
            dropout_gen=self.dropout_gen)

    def init_cache(self, batch, max_len, dtype=torch.float32):
        """KV cache for incremental decoding, on the layer's device:
        ``{"k", "v"}`` zeros ``[B, H, Tmax, hd]`` (ref:
        ``nn/layers.py:579``)."""
        shape = (batch, self.num_heads, max_len,
                 self.embed_dim // self.num_heads)
        return {"k": torch.zeros(shape, dtype=dtype, device=self.bq.device),
                "v": torch.zeros(shape, dtype=dtype, device=self.bq.device)}

    def prefill(self, x, cache, start=0):
        """Batched cache fill (ref: ``nn/layers.py:523``): project the
        whole prompt ``x`` ``[B, T, E]`` once, write its K/V into the
        cache at ``[0, T)`` (in the cache's dtype, in place) and return
        ``(causal self-attention output [B, T, E], cache)``: flash
        attention (K2 on the card) when ``use_flash``, over the projected
        K/V as they come, not the cache's rounding of them. Only ``start
        = 0`` is supported, as in the reference."""
        if start != 0:
            raise NotImplementedError(
                "MultiHeadAttention.prefill only supports start=0 "
                "(whole-prompt prefill); decode_step handles the rest")
        b, t, e = x.shape
        q, k, v = (self._heads(self._project(x, n)).transpose(1, 2)
                   for n in "qkv")                     # [B, H, T, hd]
        cache["k"][:, :, :t] = k.to(cache["k"].dtype)
        cache["v"][:, :, :t] = v.to(cache["v"].dtype)
        ctx = self._causal(q, k, v)
        return self._project(ctx.transpose(1, 2).reshape(b, t, e), "o"), \
            cache

    def decode_step(self, x_t, cache, pos, causal=True):
        """One incremental step (ref: ``nn/layers.py:587``): project the
        new token ``x_t`` ``[B, 1, E]``, write its K/V into the cache at
        ``pos`` (in place) and attend over the padded cache, positions
        past ``pos`` masked to ``-1e9``, ``probs = exp(scores -
        logsumexp(scores))``. Queries and cache meet in their promoted
        type, as jnp promotes an f32 query against a bf16 cache. Returns
        ``(out [B, 1, E], cache)``."""
        b, _, e = x_t.shape
        hd = e // self.num_heads
        q, k_t, v_t = (self._heads(self._project(x_t, n)).transpose(1, 2)
                       for n in "qkv")                 # [B, H, 1, hd]
        cache["k"][:, :, pos:pos + 1] = k_t.to(cache["k"].dtype)
        cache["v"][:, :, pos:pos + 1] = v_t.to(cache["v"].dtype)
        k, v = cache["k"], cache["v"]
        dt = torch.promote_types(q.dtype, k.dtype)
        scores = torch.einsum("bhqd,bhkd->bhqk", q.to(dt), k.to(dt)) \
            / (hd ** 0.5)
        if causal:
            valid = torch.arange(k.shape[2], device=k.device) <= pos
            scores = torch.where(valid[None, None, None, :], scores,
                                 torch.full((), -1e9, dtype=scores.dtype,
                                            device=scores.device))
        probs = torch.exp(scores - torch.logsumexp(scores, -1, keepdim=True))
        dt = torch.promote_types(probs.dtype, v.dtype)
        ctx = torch.einsum("bhqk,bhkd->bhqd", probs.to(dt), v.to(dt))
        return self._project(ctx.transpose(1, 2).reshape(b, 1, e), "o"), \
            cache

    def init_page_pool(self, num_pages, page_size, dtype=torch.float32,
                       kv_dtype=None):
        """This layer's page pool, on the layer's device."""
        hd = self.embed_dim // self.num_heads
        return att.init_page_pool(num_pages, self.num_heads, page_size, hd,
                                  dtype, kv_dtype=kv_dtype,
                                  device=self.bq.device)

    def _heads(self, y):
        b, t, e = y.shape
        return y.reshape(b, t, self.num_heads, e // self.num_heads)

    def paged_decode_step(self, x_t, pool, page_table, att_lengths,
                          write_pages, write_offsets):
        """One incremental step. x_t ``[S, 1, E]``; page_table
        ``[S, Pmax]``; att_lengths ``[S]`` valid tokens including the one
        written now; write_pages/write_offsets ``[S]`` (page id
        ``num_pages`` drops the write). Returns ``(out [S, 1, E], pool)``
        with the pool updated in place."""
        s, _, e = x_t.shape
        q = self._project(x_t, "q").reshape(s, self.num_heads, -1)
        k = self._project(x_t, "k").reshape(s, self.num_heads, -1)
        v = self._project(x_t, "v").reshape(s, self.num_heads, -1)
        att.paged_write(pool, k, v, write_pages, write_offsets)
        ctx = att.paged_decode_attention(
            q, pool["k"], pool["v"], page_table, att_lengths,
            k_scale=pool.get("k_scale"), v_scale=pool.get("v_scale"))
        return self._project(ctx.reshape(s, 1, e), "o"), pool

    def paged_prefill(self, x, pool, page_ids, offsets):
        """Prompt fill: one causal forward over the padded prompt, K/V
        scattered to ``(page_ids, offsets)`` ``[B, T]`` (page id
        ``num_pages`` drops a pad position). Returns ``(out, pool)``."""
        b, t, _ = x.shape
        chunked = torch.zeros(b, dtype=torch.bool)
        return self.paged_prefill_chunk(x, pool, page_ids, offsets, None,
                                        None, chunked)

    def paged_prefill_chunk(self, x, pool, page_ids, offsets, page_rows,
                            q_pos, chunked):
        """Chunked prompt fill. K/V of the chunk is written as in
        :meth:`paged_prefill`. A first chunk (``chunked[b]`` False)
        attends causally within the chunk through flash attention; a
        continuation chunk attends every token its slot has cached, by
        gathering its page table row (``page_rows [B, Pmax]``) and masking
        keys by absolute position (``q_pos [B, T]``). ``chunked`` is a
        host-side ``[B]`` bool tensor; each request runs only the branch
        it takes (the reference computes both and selects, with the same
        result)."""
        b, t, e = x.shape
        hd = e // self.num_heads
        q = self._heads(self._project(x, "q"))           # [B, T, H, hd]
        k = self._heads(self._project(x, "k"))
        v = self._heads(self._project(x, "v"))
        att.paged_write(pool, k.reshape(b * t, self.num_heads, hd),
                        v.reshape(b * t, self.num_heads, hd),
                        page_ids.reshape(b * t), offsets.reshape(b * t))
        q, k, v = (y.transpose(1, 2) for y in (q, k, v))  # [B, H, T, hd]
        flags = [bool(c) for c in chunked]
        first = [i for i, c in enumerate(flags) if not c]
        cont = [i for i, c in enumerate(flags) if c]
        if not cont:
            ctx = self._causal(q, k, v)
        elif not first:
            # no row selection: a list index is a copy to the card, which
            # waits for the work queued before it
            ctx = self._gathered(q, pool, page_rows, q_pos).to(q.dtype)
        else:
            ctx = torch.empty_like(q)
            ctx[first] = self._causal(q[first], k[first], v[first])
            ctx[cont] = self._gathered(q[cont], pool, page_rows[cont],
                                       q_pos[cont]).to(ctx.dtype)
        out = ctx.transpose(1, 2).reshape(b, t, e)
        return self._project(out, "o"), pool

    def _causal(self, q, k, v):
        if self.use_flash:
            return att.flash_attention(q, k, v, causal=True)
        return att.scaled_dot_product_attention(q, k, v, causal=True)

    def _gathered(self, q, pool, page_rows, q_pos):
        """Attention over the slot's whole cached prefix (pool pages were
        just updated with this chunk), f32, keys masked by absolute
        position."""
        b, h, t, hd = q.shape
        rows = page_rows.long()
        tk = rows.shape[1] * pool["k"].shape[2]
        kg, vg = pool["k"][rows], pool["v"][rows]     # [B, P, H, ps, hd]
        if att.quantized_pool(pool):
            kg = att.dequantize_pages(kg, pool["k_scale"][rows])
            vg = att.dequantize_pages(vg, pool["v_scale"][rows])
        kf = kg.movedim(2, 1).reshape(b, h, tk, hd).float()
        vf = vg.movedim(2, 1).reshape(b, h, tk, hd).float()
        scores = torch.einsum("bhqd,bhkd->bhqk", q.float(), kf) / (hd ** 0.5)
        keep = (torch.arange(tk, device=q.device)[None, None, None, :]
                <= q_pos[:, None, :, None])
        scores = torch.where(keep, scores,
                             torch.full_like(scores, att.NEG_INF))
        m = scores.amax(dim=-1, keepdim=True)
        p = torch.where(keep, torch.exp(scores - m), torch.zeros_like(scores))
        l = p.sum(dim=-1, keepdim=True)
        full = torch.einsum("bhqk,bhkd->bhqd", p, vf)
        return torch.where(l > 0, full / torch.clamp(l, min=1e-30),
                           torch.zeros_like(full))


# ------------------------------------------------ the rest of the layers

class FC(Linear):
    """ref: ``nn/layers.py:756`` — :class:`Linear` over x flattened to 2-D
    at ``num_flatten_dims`` (``ops.nn.fc``)."""

    def __init__(self, in_features, out_features, num_flatten_dims=1, **kw):
        super().__init__(in_features, out_features, **kw)
        self.num_flatten_dims = num_flatten_dims

    def forward(self, x):
        out = F.fc(x, self.weight, self.bias,
                   num_flatten_dims=self.num_flatten_dims)
        return _act(self.act, out)


class Conv2DTranspose(nn.Module):
    """ref: ``nn/layers.py:120`` — weight ``[in, out / groups, kh, kw]``
    (xavier by default), bias zeros."""

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, dilation=1, groups=1,
                 bias=True, act=None, weight_init=None, gen=None,
                 dtype=torch.float32):
        super().__init__()
        k = ((kernel_size, kernel_size) if isinstance(kernel_size, int)
             else tuple(kernel_size))
        self.stride, self.padding, self.dilation, self.groups = \
            stride, padding, dilation, groups
        self.output_padding = output_padding
        self.act = act
        self.weight = nn.Parameter((weight_init or I.xavier())(
            (in_channels, out_channels // groups) + k, gen, dtype))
        self.bias = (nn.Parameter(torch.zeros(out_channels, dtype=dtype))
                     if bias else None)

    def forward(self, x):
        out = F.conv2d_transpose(x, self.weight, self.bias, self.stride,
                                 self.padding, self.output_padding,
                                 self.dilation, self.groups)
        return _act(self.act, out)


class Conv3D(nn.Module):
    """ref: ``nn/layers.py:770`` — weight OIDHW (msra by default), bias
    zeros, over NCDHW."""

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, bias=True, act=None,
                 weight_init=None, gen=None, dtype=torch.float32):
        super().__init__()
        k = ((kernel_size,) * 3 if isinstance(kernel_size, int)
             else tuple(kernel_size))
        self.stride, self.padding, self.dilation, self.groups = \
            stride, padding, dilation, groups
        self.act = act
        self.weight = nn.Parameter((weight_init or I.msra())(
            (out_channels, in_channels // groups) + k, gen, dtype))
        self.bias = (nn.Parameter(torch.zeros(out_channels, dtype=dtype))
                     if bias else None)

    def forward(self, x):
        out = F.conv3d(x, self.weight, self.bias, self.stride, self.padding,
                       self.dilation, self.groups)
        return _act(self.act, out)


class RMSNorm(nn.Module):
    """ref: ``nn/layers.py:242`` — ``ops.nn.rms_norm`` with a ``scale``
    of ones (plain torch: the reference runs no kernel for it)."""

    def __init__(self, dim, epsilon=1e-6, dtype=torch.float32):
        super().__init__()
        self.epsilon = epsilon
        self.scale = nn.Parameter(torch.ones(dim, dtype=dtype))

    def forward(self, x):
        return F.rms_norm(x, self.scale, self.epsilon)


class GroupNorm(nn.Module):
    """ref: ``nn/layers.py:252`` — ``ops.nn.group_norm`` over NCHW, scale
    ones and bias zeros (plain torch, as the reference runs no kernel)."""

    def __init__(self, channels, groups=32, epsilon=1e-5,
                 dtype=torch.float32):
        super().__init__()
        self.groups, self.epsilon = groups, epsilon
        self.scale = nn.Parameter(torch.ones(channels, dtype=dtype))
        self.bias = nn.Parameter(torch.zeros(channels, dtype=dtype))

    def forward(self, x):
        return F.group_norm(x, self.scale, self.bias, self.groups,
                            self.epsilon)


class PRelu(nn.Module):
    """ref: ``nn/layers.py:333`` — ``alpha`` 0.25, one for ``mode="all"``
    or one a channel (axis 1) for ``mode="channel"``."""

    def __init__(self, mode="all", channels=None, dtype=torch.float32):
        super().__init__()
        self.mode = mode
        shape = (1,) if mode == "all" else (channels,)
        self.alpha = nn.Parameter(torch.full(shape, 0.25, dtype=dtype))

    def forward(self, x):
        a = self.alpha
        if self.mode == "channel":
            a = a.reshape(1, -1, *([1] * (x.ndim - 2)))
        return torch.where(x >= 0, x, a * x)


class BilinearTensorProduct(nn.Module):
    """ref: ``nn/layers.py:349`` — ``out[b, o] = x[b] W[o] y[b] +
    bias[o]``, weight ``[out, in1, in2]`` (xavier), bias zeros."""

    def __init__(self, in1_features, in2_features, out_features, gen=None,
                 dtype=torch.float32):
        super().__init__()
        self.weight = nn.Parameter(I.xavier()(
            (out_features, in1_features, in2_features), gen, dtype))
        self.bias = nn.Parameter(torch.zeros(out_features, dtype=dtype))

    def forward(self, x, y):
        return torch.einsum("bi,oij,bj->bo", x, self.weight, y) + self.bias


class SpectralNorm(nn.Module):
    """ref: ``nn/layers.py:364`` — ``weight / sigma`` by power iteration
    (``ops.tail.spectral_norm``). The iteration's vectors ``u`` ``[h]``
    and ``v`` ``[w]`` (N(0, 1) draws) are buffers, the reference's state:
    each training-mode call writes the iterated vectors back; eval mode
    reads them and leaves them as they are."""

    def __init__(self, weight_shape, dim=0, power_iters=1, eps=1e-12,
                 gen=None, dtype=torch.float32):
        super().__init__()
        self.dim, self.power_iters, self.eps = dim, power_iters, eps
        h = weight_shape[dim]
        w = 1
        for i, d in enumerate(weight_shape):
            if i != dim:
                w *= d
        self.h, self.w = h, w
        self.register_buffer("u", I.normal(0.0, 1.0)((h,), gen, dtype))
        self.register_buffer("v", I.normal(0.0, 1.0)((w,), gen, dtype))

    def forward(self, weight):
        from paddle_tpu_torch.ops.tail import spectral_norm
        # clones: the backward keeps the vectors it started from, and the
        # buffers are written below
        normed, u, v = spectral_norm(weight, self.u.clone(), self.v.clone(),
                                     dim=self.dim,
                                     power_iters=self.power_iters,
                                     eps=self.eps)
        if self.training:
            with torch.no_grad():
                self.u.copy_(u)
                self.v.copy_(v)
        return normed


class GRUUnit(nn.Module):
    """ref: ``nn/layers.py:795`` — one GRU step (``ops.rnn.gru_cell``) of
    ``x [B, I]`` and ``h [B, H]``; ``w_ih [I, 3H]``, ``w_hh [H, 3H]``
    (xavier), ``b_ih``, ``b_hh`` zeros."""

    def __init__(self, input_size, hidden_size, bias=True,
                 origin_mode=False, gen=None, dtype=torch.float32):
        super().__init__()
        self.hidden_size = hidden_size
        self.origin_mode = origin_mode
        self.w_ih = _xavier((input_size, 3 * hidden_size), gen, dtype)
        self.w_hh = _xavier((hidden_size, 3 * hidden_size), gen, dtype)
        self.b_ih = (nn.Parameter(torch.zeros(3 * hidden_size, dtype=dtype))
                     if bias else None)
        self.b_hh = (nn.Parameter(torch.zeros(3 * hidden_size, dtype=dtype))
                     if bias else None)

    def forward(self, x, h):
        return R.gru_cell(x, h, self.w_ih, self.w_hh, self.b_ih, self.b_hh,
                          origin_mode=self.origin_mode)


class NCE(nn.Module):
    """ref: ``nn/layers.py:818`` — the NCE head, weight ``[classes, dim]``
    (xavier) and bias zeros. ``forward(input, label, neg=None,
    generator=None)``: the negatives ``neg`` ``[B, num_neg_samples]`` as
    given, or drawn from ``generator`` (the reference's ``rngs={"nce":
    key}``); neither raises."""

    def __init__(self, dim, num_total_classes, num_neg_samples=10,
                 gen=None, dtype=torch.float32):
        super().__init__()
        self.num_total_classes = num_total_classes
        self.num_neg_samples = num_neg_samples
        self.weight = _xavier((num_total_classes, dim), gen, dtype)
        self.bias = nn.Parameter(torch.zeros(num_total_classes, dtype=dtype))

    def forward(self, input, label, neg=None, generator=None):
        from paddle_tpu_torch.core.enforce import enforce
        from paddle_tpu_torch.ops import loss as L
        if neg is None:
            enforce(generator is not None, "NCE needs its negatives or a "
                    "torch.Generator to draw them from")
            neg = L.nce_negatives(generator, input.shape[0],
                                  self.num_neg_samples,
                                  self.num_total_classes)
        return L.nce_loss_from(input, label, self.weight, self.bias, neg,
                               self.num_total_classes)


class TreeConv(nn.Module):
    """ref: ``nn/layers.py:877`` — TBCNN over (nodes, coefficients):
    filter ``[feature, 3, output, num_filters]`` (xavier), optional bias
    ``[num_filters]`` zeros. :meth:`build_coef` builds the coefficients
    on the host at this layer's ``max_depth``."""

    def __init__(self, feature_size, output_size, num_filters, max_depth=2,
                 act=None, bias=True, gen=None, dtype=torch.float32):
        super().__init__()
        self.max_depth = max_depth
        self.act = act
        self.filter = _xavier((feature_size, 3, output_size, num_filters),
                              gen, dtype)
        self.bias = (nn.Parameter(torch.zeros(num_filters, dtype=dtype))
                     if bias else None)

    def build_coef(self, edge_set, n_nodes):
        import numpy as np
        from paddle_tpu_torch.ops.graph import tree_patch_coefficients
        return tree_patch_coefficients(np.asarray(edge_set), n_nodes,
                                       self.max_depth)

    def forward(self, nodes_vector, coef):
        from paddle_tpu_torch.ops.graph import tree_conv
        if not isinstance(coef, torch.Tensor):
            coef = torch.as_tensor(coef, device=nodes_vector.device)
        out = tree_conv(nodes_vector, coef, self.filter)
        if self.bias is not None:
            out = out + self.bias
        return _act(self.act, out)
