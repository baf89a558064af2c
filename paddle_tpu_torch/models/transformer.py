"""Transformer (encoder-decoder) for NMT, the WMT en-de "big" and "base"
configs — the port of ``paddle_tpu/models/transformer.py``.

Post-norm layers (each residual add fused into its layer norm: K8 on the
card), dense attention as in the reference (its layers build
``MultiHeadAttention`` without ``use_flash``), the unfused ReLU FFN, and
the label-smoothed loss with the vocab projection fused into the
cross-entropy over the ``[H, V]`` ("hv") output weight, chunked in plain
torch as the reference's XLA path is.

Under ``amp.bf16_policy()`` the reference computes in f32: the f32
positional encoding promotes the bf16 embedding, and every later product
of an f32 activation with a bf16 weight is f32. The port promotes the same
way (``ops.nn.matmul``), and K8 normalizes the f32 rows with bf16
parameters. Parameter names match the JAX package's param tree
(``enc_layers.<i>.attn.wq``, ``dec_layers.<i>.cross_attn.bo``,
``out_proj.weight`` ...), so ``paddle_tpu_torch/bridge.py`` carries
weights across in both directions.
"""

import dataclasses

import torch
from torch import nn

from paddle_tpu_torch import nn as pnn
from paddle_tpu_torch.core.device import resolve_device
from paddle_tpu_torch.nn.layers import is_int8
from paddle_tpu_torch.ops import activations as A
from paddle_tpu_torch.ops.fused import fused_xent
from paddle_tpu_torch.ops.loss import softmax_with_cross_entropy


@dataclasses.dataclass
class TransformerConfig:
    src_vocab: int = 32000
    tgt_vocab: int = 32000
    d_model: int = 512
    num_heads: int = 8
    ffn_dim: int = 2048
    enc_layers: int = 6
    dec_layers: int = 6
    dropout: float = 0.1
    max_len: int = 256

    @staticmethod
    def base():
        return TransformerConfig()

    @staticmethod
    def big():
        return TransformerConfig(d_model=1024, num_heads=16, ffn_dim=4096)

    @staticmethod
    def tiny():
        return TransformerConfig(src_vocab=1000, tgt_vocab=1000, d_model=64,
                                 num_heads=4, ffn_dim=128, enc_layers=2,
                                 dec_layers=2, max_len=32)


def positional_encoding(max_len, d_model, device=None):
    """``[max_len, d_model]`` f32 sinusoids: the sines of every angle in
    the first half of the columns and their cosines in the second
    (concatenated halves, not interleaved; ref: ``transformer.py:46``)."""
    pos = torch.arange(max_len, dtype=torch.float32, device=device)[:, None]
    i = torch.arange(d_model // 2, dtype=torch.float32, device=device)[None]
    angle = pos / torch.pow(torch.tensor(10000.0, device=device),
                            2 * i / d_model)
    return torch.cat([torch.sin(angle), torch.cos(angle)], dim=-1)


class EncoderLayer(nn.Module):
    def __init__(self, cfg, gen=None, dropout_gen=None):
        super().__init__()
        self.attn = pnn.MultiHeadAttention(cfg.d_model, cfg.num_heads,
                                           dropout=cfg.dropout, gen=gen,
                                           dropout_gen=dropout_gen)
        self.ln1 = pnn.LayerNorm(cfg.d_model)
        self.fc1 = pnn.Linear(cfg.d_model, cfg.ffn_dim, gen=gen)
        self.fc2 = pnn.Linear(cfg.ffn_dim, cfg.d_model, gen=gen)
        self.ln2 = pnn.LayerNorm(cfg.d_model)
        self.drop = pnn.Dropout(cfg.dropout, gen=dropout_gen)

    def forward(self, x, mask=None):
        x = self.ln1(self.drop(self.attn(x, mask=mask)), residual=x)
        return self.ln2(self.drop(self.fc2(A.relu(self.fc1(x)))),
                        residual=x)


class DecoderLayer(nn.Module):
    def __init__(self, cfg, gen=None, dropout_gen=None):
        super().__init__()
        self.self_attn = pnn.MultiHeadAttention(
            cfg.d_model, cfg.num_heads, dropout=cfg.dropout, gen=gen,
            dropout_gen=dropout_gen)
        self.cross_attn = pnn.MultiHeadAttention(
            cfg.d_model, cfg.num_heads, dropout=cfg.dropout, gen=gen,
            dropout_gen=dropout_gen)
        self.ln1 = pnn.LayerNorm(cfg.d_model)
        self.ln2 = pnn.LayerNorm(cfg.d_model)
        self.ln3 = pnn.LayerNorm(cfg.d_model)
        self.fc1 = pnn.Linear(cfg.d_model, cfg.ffn_dim, gen=gen)
        self.fc2 = pnn.Linear(cfg.ffn_dim, cfg.d_model, gen=gen)
        self.drop = pnn.Dropout(cfg.dropout, gen=dropout_gen)

    def forward(self, x, memory, self_mask=None, cross_mask=None):
        x = self.ln1(self.drop(self.self_attn(x, causal=True,
                                              mask=self_mask)), residual=x)
        x = self.ln2(self.drop(self.cross_attn(x, kv=memory,
                                               mask=cross_mask)),
                     residual=x)
        return self.ln3(self.drop(self.fc2(A.relu(self.fc1(x)))),
                        residual=x)


class Transformer(nn.Module):
    """The encoder-decoder (ref: ``transformer.py:96``). Weights are drawn
    from ``seed`` on the CPU and moved to ``device``, which defaults to
    the card and raises when there is none; dropout masks come from
    ``dropout_gen``, a generator on ``device`` seeded with ``seed``."""

    def __init__(self, cfg: TransformerConfig, device="cuda", seed=0):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        gen = torch.Generator().manual_seed(seed)
        self.dropout_gen = torch.Generator(device=dev).manual_seed(seed)
        self.src_emb = pnn.Embedding(cfg.src_vocab, cfg.d_model, gen=gen)
        self.tgt_emb = pnn.Embedding(cfg.tgt_vocab, cfg.d_model, gen=gen)
        self.enc_layers = nn.ModuleList(
            EncoderLayer(cfg, gen, self.dropout_gen)
            for _ in range(cfg.enc_layers))
        self.dec_layers = nn.ModuleList(
            DecoderLayer(cfg, gen, self.dropout_gen)
            for _ in range(cfg.dec_layers))
        self.out_proj = pnn.Linear(cfg.d_model, cfg.tgt_vocab, bias=False,
                                   gen=gen)
        self.drop = pnn.Dropout(cfg.dropout, gen=self.dropout_gen)
        self.to(dev)

    @property
    def device(self):
        return next(self.parameters()).device

    def _embed(self, emb, ids):
        pe = positional_encoding(ids.shape[1], self.cfg.d_model, ids.device)
        return self.drop(emb(ids) * (self.cfg.d_model ** 0.5) + pe[None])

    def encode(self, src, src_mask=None):
        """``[B, S, D]`` memory; ``src_mask`` ``[B, S]`` (1 = a real
        token) masks the padded keys."""
        x = self._embed(self.src_emb, src)
        mask = src_mask[:, None, None, :] if src_mask is not None else None
        for layer in self.enc_layers:
            x = layer(x, mask=mask)
        return x

    def decode_hidden(self, tgt, memory, src_mask=None):
        """The decoder stack's output ``[B, T, D]`` before the vocab
        projection (the fused loss takes it directly)."""
        x = self._embed(self.tgt_emb, tgt)
        cross = src_mask[:, None, None, :] if src_mask is not None else None
        for layer in self.dec_layers:
            x = layer(x, memory, cross_mask=cross)
        return x

    def decode(self, tgt, memory, src_mask=None):
        return self.out_proj(self.decode_hidden(tgt, memory, src_mask))

    def forward(self, src, tgt, src_mask=None):
        """Logits ``[B, T, V]``."""
        return self.decode(tgt, self.encode(src, src_mask), src_mask)

    def loss(self, src, tgt_in, tgt_out, src_mask=None, pad_id=0,
             label_smoothing=0.1, vocab_axis=None, batch_axis=None,
             mesh=None, mesh_plan=None):
        """The label-smoothed NMT loss, a scalar f32 (ref:
        ``transformer.py:134``): the vocab projection fused into the
        chunked cross-entropy over ``out_proj``'s ``[H, V]`` weight, so no
        ``[B, T, V]`` logits or one-hot labels exist; the mean over the
        positions whose ``tgt_out`` is not ``pad_id``. The reference's
        ``PT_FUSED_XENT=0`` switch has no counterpart (:func:`nmt_loss`
        is the parity composition, and the loss over a weight-only int8
        ``out_proj``, as in the reference); the vocab-sharded loss waits
        for multi-GPU."""
        if any(a is not None for a in (vocab_axis, batch_axis, mesh,
                                        mesh_plan)):
            raise NotImplementedError(
                "Transformer.loss: the vocab-sharded loss (vocab_axis, "
                "batch_axis, mesh, mesh_plan) is not ported")
        memory = self.encode(src, src_mask)
        h = self.decode_hidden(tgt_in, memory, src_mask)
        if is_int8(self.out_proj):
            return nmt_loss(self.out_proj(h), tgt_out, pad_id,
                            label_smoothing)
        ce = fused_xent(h, self.out_proj.weight, tgt_out, weight_layout="hv",
                        label_smoothing=label_smoothing)
        valid = (tgt_out != pad_id).to(torch.float32)
        return (ce * valid).sum() / torch.clamp(valid.sum(), min=1.0)


def nmt_loss(logits, labels, pad_id=0, label_smoothing=0.1):
    """Label-smoothed cross-entropy of materialized logits, pads ignored
    (ref: ``transformer.py:166``): the label column takes ``1 - ls``,
    every other ``ls / (V - 1)``. The parity composition for
    :meth:`Transformer.loss`."""
    vocab = logits.shape[-1]
    valid = (labels != pad_id).to(torch.float32)
    pos = 1.0 - label_smoothing
    neg = label_smoothing / (vocab - 1)
    onehot = torch.nn.functional.one_hot(labels.long(), vocab).to(
        torch.float32) * (pos - neg) + neg
    loss = softmax_with_cross_entropy(logits, onehot, soft_label=True)[..., 0]
    return (loss * valid).sum() / torch.clamp(valid.sum(), min=1.0)
