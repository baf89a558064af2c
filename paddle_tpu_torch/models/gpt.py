"""Decoder-only causal LM (GPT-style) — the port of
``paddle_tpu/models/gpt.py``: the config, the pre-norm blocks (a dense or
a mixture-of-experts FFN), the full forward, unrolled or as a scan over
stacked layers with remat, the training loss (``GPT.loss``, the fused
cross-entropy against the tied embedding), and ``GPTDecoder``'s
incremental decoding: the padded KV cache (``init_caches``,
``decode_step``, ``generate``) and the paged serving methods.

Caches and pools are updated in place (the reference returns new ones
from its jitted step); each method still returns them, so that call
sites read like the reference's. Every weight may be weight-only int8
(``quant.quantize_weights_int8``, or an int8 tree through the bridge).
"""

import dataclasses

import torch
from torch import nn

from paddle_tpu_torch import nn as pnn
from paddle_tpu_torch.core.device import resolve_device
from paddle_tpu_torch.core.enforce import enforce
from paddle_tpu_torch.nn.layers import is_int8
from paddle_tpu_torch.ops.fused import fused_xent
from paddle_tpu_torch.ops.loss import softmax_with_cross_entropy


@dataclasses.dataclass
class GPTConfig:
    vocab_size: int = 32000
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position: int = 2048
    dropout: float = 0.1
    use_flash: bool = True
    seq_axis: str = None       # ring sequence parallelism: not ported
    moe_experts: int = 0       # >0: MoE FFN with this many experts
    moe_k: int = 2
    moe_ep_axis: str = None    # expert parallelism: not ported
    scan_layers: bool = False  # stacked block params, one layer at a time
    remat: str = None          # nothing|dots_saveable|full (None: nothing)

    @staticmethod
    def small():
        return GPTConfig()

    @staticmethod
    def tiny():
        return GPTConfig(vocab_size=512, hidden_size=64, num_layers=2,
                         num_heads=4, intermediate_size=128,
                         max_position=128)

    def check_ported(self):
        """The multi-GPU options raise: ring sequence parallelism and
        expert parallelism."""
        for name in ("seq_axis", "moe_ep_axis"):
            if getattr(self, name) is not None:
                raise NotImplementedError(
                    f"GPTConfig.{name} needs several GPUs and is not "
                    "ported to paddle_tpu_torch")
        pnn.resolve_remat(self.remat)


class GPTBlock(nn.Module):
    def __init__(self, cfg: GPTConfig, gen=None, dropout_gen=None):
        super().__init__()
        self.cfg = cfg
        self.ln1 = pnn.LayerNorm(cfg.hidden_size)
        self.attn = pnn.MultiHeadAttention(cfg.hidden_size, cfg.num_heads,
                                           dropout=cfg.dropout,
                                           use_flash=cfg.use_flash, gen=gen,
                                           dropout_gen=dropout_gen)
        self.ln2 = pnn.LayerNorm(cfg.hidden_size)
        if cfg.moe_experts:
            self.mlp = pnn.MoE(cfg.hidden_size, cfg.intermediate_size,
                               cfg.moe_experts, k=cfg.moe_k,
                               ep_axis=cfg.moe_ep_axis, gen=gen)
        else:
            self.fc1 = pnn.Linear(cfg.hidden_size, cfg.intermediate_size,
                                  gen=gen)
            self.fc2 = pnn.Linear(cfg.intermediate_size, cfg.hidden_size,
                                  gen=gen)
        self.drop = pnn.Dropout(cfg.dropout, gen=dropout_gen)

    def _ffn(self, x):
        if self.cfg.moe_experts:
            return self.mlp(x)
        return pnn.fused_ffn(self.fc1, self.fc2, x)

    def forward(self, x):
        # pre-norm residual blocks (GPT-2 style)
        x = x + self.drop(self.attn(self.ln1(x), causal=True))
        return x + self.drop(self._ffn(self.ln2(x)))

    def decode_step(self, x, cache, pos):
        """The incremental twin of forward through the KV cache (no
        dropout)."""
        h, cache = self.attn.decode_step(self.ln1(x), cache, pos)
        x = x + h
        return x + self._ffn(self.ln2(x)), cache

    def prefill(self, x, cache, start=0):
        """Whole-prompt cache fill: one causal forward (no dropout)."""
        h, cache = self.attn.prefill(self.ln1(x), cache, start)
        x = x + h
        return x + self._ffn(self.ln2(x)), cache

    def paged_decode_step(self, x, pool, page_table, att_lengths,
                          write_pages, write_offsets):
        h, pool = self.attn.paged_decode_step(
            self.ln1(x), pool, page_table, att_lengths, write_pages,
            write_offsets)
        x = x + h
        return x + self._ffn(self.ln2(x)), pool

    def paged_prefill_chunk(self, x, pool, page_ids, offsets, page_rows,
                            q_pos, chunked):
        h, pool = self.attn.paged_prefill_chunk(
            self.ln1(x), pool, page_ids, offsets, page_rows, q_pos, chunked)
        x = x + h
        return x + self._ffn(self.ln2(x)), pool


class GPT(nn.Module):
    """Causal LM returning next-token logits ``[B, T, V]`` (weight-tied
    head). Weights are drawn from ``seed`` on the CPU (so a seed gives
    the same weights on every machine) and moved to ``device``, which
    defaults to the card and raises when there is none. Dropout masks
    come from ``dropout_gen``, a generator on ``device`` seeded with
    ``seed``. With ``cfg.scan_layers`` the blocks are one
    :class:`nn.ScanLayers` (``blocks.layer.<param>`` with a leading layer
    axis, the reference's scan tree) under ``cfg.remat``; they are drawn
    as the unrolled blocks are, so both layouts of one seed hold the same
    weights."""

    def __init__(self, cfg: GPTConfig, device="cuda", seed=0):
        super().__init__()
        cfg.check_ported()
        dev = resolve_device(device)
        self.cfg = cfg
        gen = torch.Generator().manual_seed(seed)
        self.dropout_gen = torch.Generator(device=dev).manual_seed(seed)
        self.tok_emb = pnn.Embedding(cfg.vocab_size, cfg.hidden_size,
                                     gen=gen)
        self.pos_emb = pnn.Embedding(cfg.max_position, cfg.hidden_size,
                                     gen=gen)
        self.drop = pnn.Dropout(cfg.dropout, gen=self.dropout_gen)
        blocks = [GPTBlock(cfg, gen, self.dropout_gen)
                  for _ in range(cfg.num_layers)]
        if cfg.scan_layers:
            self.blocks = pnn.ScanLayers(
                blocks, remat=cfg.remat,
                gens=(self.dropout_gen,) if cfg.dropout > 0 else ())
        else:
            self.blocks = nn.ModuleList(blocks)
        self.ln_f = pnn.LayerNorm(cfg.hidden_size)
        self.to(dev)

    @property
    def device(self):
        return self.ln_f.scale.device

    def hidden(self, input_ids, pos_offset=0):
        """Final post-LN hidden states ``[B, T, H]``."""
        _, t = input_ids.shape
        pos = pos_offset + torch.arange(t, device=self.device)[None, :]
        x = self.drop(self.tok_emb(input_ids) + self.pos_emb(pos))
        if self.cfg.scan_layers:
            x = self.blocks(x)
        else:
            for blk in self.blocks:
                x = blk(x)
        return self.ln_f(x)

    def forward(self, input_ids, pos_offset=0):
        return pnn.tied_vocab_head(self.tok_emb,
                                   self.hidden(input_ids, pos_offset))

    def loss(self, input_ids, labels=None, pad_id=None):
        """Shifted next-token cross entropy, a scalar f32 (ref:
        ``models/gpt.py:174``): the fused cross-entropy against the tied
        embedding table (K5 forward, K6 backward on the card), so no
        ``[B, T, V]`` logits exist. ``pad_id`` averages over the
        positions whose label is not ``pad_id``. Over an int8 table the
        loss is :func:`lm_loss` of the logits, as in the reference. Vocab
        and batch sharding wait for multi-GPU. A MoE model's aux loss is
        not added, as in the reference."""
        if labels is None:
            labels = input_ids
        h = self.hidden(input_ids)
        if is_int8(self.tok_emb):
            return lm_loss(pnn.tied_vocab_head(self.tok_emb, h), labels,
                           pad_id)
        ce = fused_xent(h[:, :-1], self.tok_emb.weight, labels[:, 1:])
        return _masked_mean(ce, labels[:, 1:], pad_id)


def _masked_mean(ce, tgt, pad_id):
    if pad_id is None:
        return ce.mean()
    valid = (tgt != pad_id).to(ce.dtype)
    return (ce * valid).sum() / torch.clamp(valid.sum(), min=1.0)


def lm_loss(logits, labels, pad_id=None):
    """Shifted next-token cross entropy of materialized logits ``[B, T,
    V]``, optionally ignoring pad positions — the parity composition for
    :meth:`GPT.loss` (ref: ``models/gpt.py:207``)."""
    tgt = labels[:, 1:]
    ce = softmax_with_cross_entropy(logits[:, :-1], tgt[..., None])[..., 0]
    return _masked_mean(ce, tgt, pad_id)


class GPTDecoder(GPT):
    """GPT plus incremental decoding: the padded KV cache of
    :meth:`generate` and the paged serving methods the serving engine
    drives. It steps per-layer caches, so it refuses ``scan_layers``;
    a scan model's tree converts with ``io.unstack_layer_tree``."""

    def __init__(self, cfg: GPTConfig, device="cuda", seed=0):
        enforce(not cfg.scan_layers,
                "GPTDecoder steps per-layer KV caches and needs unrolled "
                "blocks (scan_layers=False); train params saved from a "
                "scan model convert via io.checkpoint.unstack_layer_tree")
        super().__init__(cfg, device=device, seed=seed)

    def init_caches(self, batch, max_len, dtype=torch.float32):
        """Per-layer KV caches ``{"k", "v"}`` ``[B, H, max_len, hd]`` on
        the model's device (ref: ``models/gpt.py:254``)."""
        return [blk.attn.init_cache(batch, max_len, dtype)
                for blk in self.blocks]

    def decode_step(self, token, caches, pos):
        """One incremental forward of ``token`` ``[B, 1]`` at position
        ``pos`` (an int) through every block's KV cache -> ``(logits [B,
        1, V], caches)``, the caches written in place (ref:
        ``models/gpt.py:219``; the reshape undoes lookup_table's
        trailing-1 squeeze)."""
        b = token.shape[0]
        pos_ids = torch.full(token.shape, pos, dtype=torch.long,
                             device=token.device)
        x = (self.tok_emb(token) + self.pos_emb(pos_ids)).reshape(
            b, 1, self.cfg.hidden_size)
        for blk, cache in zip(self.blocks, caches):
            x, _ = blk.decode_step(x, cache, pos)
        return pnn.tied_vocab_head(self.tok_emb, self.ln_f(x)), caches

    def prefill(self, prompt, max_len, cache_dtype=torch.float32):
        """generate's batched prefill: one causal forward of ``prompt``
        ``[B, Tp]`` fills new caches of ``max_len`` positions -> ``(logits
        of the last prompt position [B, 1, V], caches)``."""
        tp = prompt.shape[1]
        caches = self.init_caches(prompt.shape[0], max_len, dtype=cache_dtype)
        x = self.tok_emb(prompt) + self.pos_emb(
            torch.arange(tp, device=prompt.device)[None, :])
        for blk, cache in zip(self.blocks, caches):
            x, _ = blk.prefill(x, cache, start=0)
        return (pnn.tied_vocab_head(self.tok_emb, self.ln_f(x[:, -1:, :])),
                caches)

    @torch.no_grad()
    def generate(self, prompt, max_new, temperature=0.0, generator=None,
                 cache_dtype=torch.float32):
        """Greedy (``temperature`` 0) or sampled generation (ref:
        ``models/gpt.py:394``): one batched prefill of the ``[B, Tp]``
        prompt fills every layer's cache, then ``max_new`` decode steps,
        each drawing the next token from the last logits (argmax, or a
        categorical draw at ``logits / temperature`` from the explicit
        ``generator`` on the model's device, which sampling requires).
        ``cache_dtype`` is the caches' storage type (bf16 halves the bytes
        each decode step reads). Returns ``[B, Tp + max_new]``, the
        prompt included."""
        enforce(temperature <= 0.0 or generator is not None,
                "sampled generation (temperature > 0) requires a "
                "torch.Generator")
        enforce(prompt.device == self.device,
                f"prompt on {prompt.device}, model on {self.device}")
        b, tp = prompt.shape
        enforce(tp + max_new <= self.cfg.max_position,
                f"prompt {tp} + max_new {max_new} > max_position "
                f"{self.cfg.max_position}")
        logits, caches = self.prefill(prompt, tp + max_new, cache_dtype)
        new = []
        for t in range(max_new):
            if temperature <= 0.0:
                tok = torch.argmax(logits[:, 0], dim=-1)
            else:
                probs = torch.softmax(logits[:, 0].float() / temperature, -1)
                tok = torch.multinomial(probs, 1, generator=generator)[:, 0]
            tok = tok.to(prompt.dtype)[:, None]
            new.append(tok)
            logits, caches = self.decode_step(tok, caches, tp + t)
        return torch.cat([prompt] + new, dim=1)

    def init_paged_caches(self, num_pages, page_size, dtype=torch.float32,
                          kv_dtype=None):
        """Per-layer page pools on the model's device; ``kv_dtype=
        torch.int8`` stores int8 values with per-row scales."""
        return [blk.attn.init_page_pool(num_pages, page_size, dtype,
                                        kv_dtype=kv_dtype)
                for blk in self.blocks]

    def paged_decode_step(self, tokens, caches, page_table, lengths,
                          active):
        """One serve-step forward for all slots. tokens ``[S]`` (the
        pending token per slot, at position ``lengths``); page_table
        ``[S, Pmax]`` in range everywhere; lengths ``[S]`` tokens already
        cached; active ``[S]`` bool. The new token's K/V lands at
        ``page_table[s, lengths // ps]`` offset ``lengths % ps`` (dropped
        for inactive slots); attention covers ``lengths + 1`` tokens.
        -> ``(logits [S, V], caches)``, the caches updated in place."""
        s = tokens.shape[0]
        num_pages, _, page_size, _ = caches[0]["k"].shape
        p_max = page_table.shape[1]
        # the reference's gather clamps an index past Pmax; torch raises
        col = torch.clamp(lengths // page_size, max=p_max - 1)
        write_pages = page_table[torch.arange(s, device=tokens.device),
                                 col.long()]
        write_pages = torch.where(active, write_pages,
                                  torch.full_like(write_pages, num_pages))
        write_offsets = lengths % page_size
        att_lengths = lengths + active.to(lengths.dtype)
        pos = torch.clamp(lengths, max=self.cfg.max_position - 1)
        x = (self.tok_emb(tokens[:, None]) + self.pos_emb(pos[:, None])
             ).reshape(s, 1, self.cfg.hidden_size)
        for blk, pool in zip(self.blocks, caches):
            x, _ = blk.paged_decode_step(x, pool, page_table, att_lengths,
                                         write_pages, write_offsets)
        x = self.ln_f(x)
        return pnn.tied_vocab_head(self.tok_emb, x)[:, 0], caches

    def paged_prefill(self, prompt, lengths, caches, page_rows):
        """Admission prefill of whole prompts: the ``starts = 0`` case of
        :meth:`paged_prefill_chunk`."""
        starts = torch.zeros(prompt.shape[0], dtype=torch.int32)
        return self.paged_prefill_chunk(prompt, starts, lengths, caches,
                                        page_rows)

    def paged_prefill_chunk(self, prompt, starts, chunk_lengths, caches,
                            page_rows, write_floor=None):
        """Chunked admission prefill: the ``[B, Lp]`` window holds tokens
        at absolute positions ``starts[b] .. starts[b] + chunk_lengths[b]
        - 1``. ``starts`` is read on the host to pick each request's
        attention branch (first chunk or continuation). ``write_floor``
        (``[B]``, optional): K/V writes below that absolute position are
        dropped, so the prefix-cache pages the engine maps there stay
        bitwise untouched. Returns (logits of each request's last chunk
        token ``[B, V]``, caches)."""
        x, caches = self._paged_chunk_hidden(prompt, starts, chunk_lengths,
                                             caches, page_rows, write_floor)
        last = torch.clamp(chunk_lengths.to(x.device).long() - 1, min=0)
        x_last = x[torch.arange(x.shape[0], device=x.device), last]
        return pnn.tied_vocab_head(self.tok_emb, x_last), caches

    def _paged_chunk_hidden(self, prompt, starts, chunk_lengths, caches,
                            page_rows, write_floor=None, chunked=None):
        """Run the window through every block; returns the post-``ln_f``
        hidden states ``[B, Lp, H]`` and the caches. Positions outside the
        chunk, and below ``write_floor``, write to page ``num_pages``,
        which drops them. ``chunked`` (``B`` host bools: each row's
        branch, continuation where True) is read from ``starts`` on the
        host when None."""
        dev = self.device
        enforce(prompt.device == dev, f"prompt on {prompt.device}, model "
                f"on {dev}")
        b, lp = prompt.shape
        num_pages, _, page_size, _ = caches[0]["k"].shape
        p_max = page_rows.shape[1]
        if chunked is None:
            chunked = starts.cpu() > 0
        # non-blocking: from pinned memory the copy does not wait for the
        # work queued before it (a blocking copy synchronizes the stream)
        starts = starts.to(dev, non_blocking=True).long()
        chunk_lengths = chunk_lengths.to(dev).long()
        rel = torch.arange(lp, device=dev)
        pos = starts[:, None] + rel[None, :]                  # [B, Lp]
        in_chunk = rel[None, :] < chunk_lengths[:, None]
        # the reference's take_along_axis clamps; torch raises
        col = torch.clamp(pos // page_size, max=p_max - 1)
        page_ids = torch.gather(page_rows.long(), 1, col)
        if write_floor is not None:
            in_chunk &= pos >= write_floor.to(dev).long()[:, None]
        page_ids = torch.where(in_chunk, page_ids,
                               torch.full_like(page_ids, num_pages))
        offsets = pos % page_size
        emb_pos = torch.clamp(pos, max=self.cfg.max_position - 1)
        x = self.tok_emb(prompt) + self.pos_emb(emb_pos)
        for blk, pool in zip(self.blocks, caches):
            x, _ = blk.paged_prefill_chunk(x, pool, page_ids, offsets,
                                           page_rows, pos, chunked)
        return self.ln_f(x), caches

    def paged_verify_chunk(self, window, starts, win_lengths, caches,
                           page_rows, chunked=None):
        """Speculative-decoding verify (ref: ``models/gpt.py:371``): score
        every position of a ``[B, W]`` token window at absolute positions
        ``starts[b] .. starts[b] + win_lengths[b] - 1`` against the paged
        cache, through the chunked prefill's path (a live slot has
        ``starts >= 1``, so its rows take the continuation branch: the
        slot's whole cached prefix plus the window, causally). The
        window's K/V is written into the slot's pages; rejecting a
        proposal is the caller's length edit. ``starts`` is read on the
        host, unless ``chunked`` (``B`` host bools) gives each row's
        branch: a traced verify passes it, since a host read of a traced
        tensor has no value. Returns (hidden ``[B, W, H]``, caches); the
        caller applies :meth:`verify_head` one position at a time, so no
        ``[B, W, V]`` logits exist."""
        return self._paged_chunk_hidden(window, starts, win_lengths, caches,
                                        page_rows, chunked=chunked)

    def verify_head(self, hidden_row):
        """Vocab logits of one window position: ``[B, H] -> [B, V]`` (the
        tied head; ref: ``models/gpt.py:388``)."""
        return pnn.tied_vocab_head(self.tok_emb, hidden_row)
