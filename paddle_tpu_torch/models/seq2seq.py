"""Attention seq2seq NMT, the machine-translation book model — the port of
``paddle_tpu/models/seq2seq.py``.

A bidirectional GRU encoder over padded source rows (``nn.GRU`` with
lengths), a GRU decoder cell fed by additive (Bahdanau) attention at each
step, teacher-forced training, greedy decoding and static-shape beam
search (``ops.rnn.beam_search_decode``). The reference runs no Pallas
kernel here (its scans and attention are XLA), so neither does the port:
each recurrence is a Python loop over time steps of plain torch ops.

Parameter names match the JAX package's param tree (``encoder.w_ih_l0d0``,
``dec_w_ih``, ``att_q``, ``out_proj.weight`` ...), so
``paddle_tpu_torch/bridge.py`` carries weights across in both directions.
"""

import dataclasses

import torch
from torch import nn

from paddle_tpu_torch import nn as pnn
from paddle_tpu_torch.core.device import resolve_device
from paddle_tpu_torch.nn.layers import _xavier
from paddle_tpu_torch.ops import rnn as R
from paddle_tpu_torch.ops.nn import matmul


@dataclasses.dataclass
class Seq2SeqConfig:
    src_vocab: int = 1024
    tgt_vocab: int = 1024
    embed_dim: int = 64
    hidden: int = 128
    bidirectional_encoder: bool = True
    dropout: float = 0.0

    @staticmethod
    def tiny():
        return Seq2SeqConfig(src_vocab=64, tgt_vocab=64, embed_dim=16,
                             hidden=32)


class AttentionSeq2Seq(nn.Module):
    """GRU encoder-decoder with additive attention (ref:
    ``seq2seq.py:40``). Weights are drawn from ``seed`` on the CPU and
    moved to ``device``, which defaults to the card and raises when there
    is none; dropout masks come from ``dropout_gen``, a generator on
    ``device`` seeded with ``seed``."""

    def __init__(self, cfg: Seq2SeqConfig, device="cuda", seed=0):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        h = cfg.hidden
        gen = torch.Generator().manual_seed(seed)
        self.dropout_gen = torch.Generator(device=dev).manual_seed(seed)
        self.src_embed = pnn.Embedding(cfg.src_vocab, cfg.embed_dim, gen=gen)
        self.tgt_embed = pnn.Embedding(cfg.tgt_vocab, cfg.embed_dim, gen=gen)
        self.encoder = pnn.GRU(cfg.embed_dim, h,
                               bidirectional=cfg.bidirectional_encoder,
                               gen=gen)
        enc_out = h * (2 if cfg.bidirectional_encoder else 1)
        self.enc_proj = pnn.Linear(enc_out, h, gen=gen)
        # the decoder's GRU cell (attention feeds each step)
        self.dec_w_ih = _xavier((cfg.embed_dim + enc_out, 3 * h), gen,
                                torch.float32)
        self.dec_w_hh = _xavier((h, 3 * h), gen, torch.float32)
        self.dec_b = nn.Parameter(torch.zeros(3 * h))
        # additive attention
        self.att_q = _xavier((h, h), gen, torch.float32)
        self.att_k = _xavier((enc_out, h), gen, torch.float32)
        self.att_v = _xavier((h, 1), gen, torch.float32)
        self.out_proj = pnn.Linear(h, cfg.tgt_vocab, gen=gen)
        self.dropout = pnn.Dropout(cfg.dropout, gen=self.dropout_gen)
        self.to(dev)

    @property
    def device(self):
        return self.dec_b.device

    def encode(self, src_ids, src_lengths):
        """``(enc_out [B, S, E], att_keys [B, S, H], mask [B, S], h0 [B,
        H])``: h0 is tanh of the projected mean of the valid encoder
        outputs."""
        enc_out, _ = self.encoder(self.src_embed(src_ids),
                                  lengths=src_lengths)
        s = src_ids.shape[1]
        mask = (torch.arange(s, device=src_ids.device)[None, :]
                < src_lengths[:, None])
        mean = ((enc_out * mask[..., None]).sum(1)
                / torch.clamp(src_lengths[:, None], min=1))
        h0 = torch.tanh(self.enc_proj(mean))
        att_keys = matmul(enc_out, self.att_k)   # hoisted: loop-invariant
        return enc_out, att_keys, mask, h0

    def _attend(self, h, enc_out, att_keys, enc_mask):
        """h ``[B, H]`` -> (context ``[B, E]``, weights ``[B, S]``)."""
        q = matmul(h, self.att_q)
        e = matmul(torch.tanh(q[:, None, :] + att_keys), self.att_v)[..., 0]
        e = torch.where(enc_mask, e, torch.full_like(e, R.NEG_INF))
        w = torch.softmax(e, dim=-1)
        return torch.einsum("bs,bse->be", w, enc_out), w

    def _dec_step(self, h, y_emb, enc_out, att_keys, enc_mask):
        ctx, _ = self._attend(h, enc_out, att_keys, enc_mask)
        x = torch.cat([y_emb, ctx], dim=-1)
        return R.gru_cell(x, h, self.dec_w_ih, self.dec_w_hh, self.dec_b)

    def forward(self, src_ids, src_lengths, tgt_ids):
        """Teacher-forced training: tgt_ids ``[B, T]`` (BOS first);
        returns the logits ``[B, T, V]`` of the next tokens."""
        enc_out, att_keys, mask, h = self.encode(src_ids, src_lengths)
        y = self.dropout(self.tgt_embed(tgt_ids))
        hs = []
        for t in range(y.shape[1]):
            h = self._dec_step(h, y[:, t], enc_out, att_keys, mask)
            hs.append(h)
        return self.out_proj(torch.stack(hs, dim=1))

    def greedy_decode(self, src_ids, src_lengths, bos_id, eos_id, max_len):
        """Greedy decode -> ``[B, max_len]`` int32 token ids; after a row
        emits ``eos_id`` it emits only ``eos_id``."""
        enc_out, att_keys, mask, h = self.encode(src_ids, src_lengths)
        b = src_ids.shape[0]
        tok = torch.full((b,), bos_id, dtype=torch.int32,
                         device=src_ids.device)
        done = torch.zeros(b, dtype=torch.bool, device=src_ids.device)
        toks = []
        for _ in range(max_len):
            h = self._dec_step(h, self.tgt_embed(tok), enc_out, att_keys,
                               mask)
            nxt = torch.argmax(self.out_proj(h), dim=-1).to(torch.int32)
            nxt = torch.where(done, torch.full_like(nxt, eos_id), nxt)
            done = done | (nxt == eos_id)
            tok = nxt
            toks.append(nxt)
        return torch.stack(toks, dim=1)

    def beam_decode(self, src_ids, src_lengths, bos_id, eos_id, beam_size,
                    max_len):
        """Beam-search decode -> ``(sequences [B, K, max_len] int32, scores
        [B, K])`` (ref: ``seq2seq.py:126``)."""
        b, k = src_ids.shape[0], beam_size
        enc_out, att_keys, mask, h0 = self.encode(src_ids, src_lengths)
        enc_k, keys_k, mask_k, h_k = (
            torch.repeat_interleave(t, k, dim=0)
            for t in (enc_out, att_keys, mask, h0))

        def log_probs_fn(tokens, h):
            h = self._dec_step(h, self.tgt_embed(tokens), enc_k, keys_k,
                               mask_k)
            return torch.log_softmax(self.out_proj(h), dim=-1), h

        return R.beam_search_decode(log_probs_fn, h_k, bos_id, eos_id, k,
                                    max_len, b, self.cfg.tgt_vocab)


def nmt_loss(logits, labels, lengths):
    """Cross-entropy of the gold next tokens ``labels`` ``[B, T]``,
    averaged over the first ``lengths[b]`` positions of each row (ref:
    ``seq2seq.py:149``)."""
    t = labels.shape[1]
    mask = (torch.arange(t, device=labels.device)[None, :]
            < lengths[:, None]).to(logits.dtype)
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, labels.long()[..., None])[..., 0]
    return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
