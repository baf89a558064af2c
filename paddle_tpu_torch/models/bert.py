"""BERT — the transformer encoder for masked-LM pretraining, the port of
``paddle_tpu/models/bert.py``: the config, the post-norm layers (the
residual add fused into the layer norm, K8 on the card), the encoder,
and the MLM + NSP heads with the fused pretraining loss
(``BertForPretraining.loss``: the MLM vocab projection fused into the
cross-entropy, K5 forward and K6 backward on the card).

Parameter names match the JAX package's param tree
(``encoder.layers.<i>.attn.wq``, ``mlm_bias``, ``pooler.weight`` ...), so
``paddle_tpu_torch/bridge.py`` carries weights across in both directions.
With ``scan_layers`` the encoder's layers are one :class:`nn.ScanLayers`
(``encoder.layers.layer.<param>`` with a leading layer axis, the JAX
package's scan tree) under ``remat``.
"""

import dataclasses

import torch
from torch import nn

from paddle_tpu_torch import nn as pnn
from paddle_tpu_torch.core.device import resolve_device
from paddle_tpu_torch.nn.layers import is_int8
from paddle_tpu_torch.ops.fused import fused_xent
from paddle_tpu_torch.ops.loss import softmax_with_cross_entropy


@dataclasses.dataclass
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position: int = 512
    type_vocab_size: int = 2
    dropout: float = 0.1
    use_flash: bool = True
    scan_layers: bool = False  # stacked layer params, one layer at a time
    remat: str = None          # nothing|dots_saveable|full (None: nothing)

    @staticmethod
    def base():
        return BertConfig()

    @staticmethod
    def tiny():
        return BertConfig(vocab_size=1024, hidden_size=64, num_layers=2,
                          num_heads=4, intermediate_size=128,
                          max_position=128)

    @staticmethod
    def large():
        return BertConfig(hidden_size=1024, num_layers=24, num_heads=16,
                          intermediate_size=4096)

    def check_ported(self):
        """Validates ``remat``; every option of the config is ported."""
        pnn.resolve_remat(self.remat)


class TransformerLayer(nn.Module):
    """Post-norm encoder layer: ``ln1(drop(attn(x)) + x)``, then
    ``ln2(drop(ffn(x)) + x)``, each residual add fused into its layer
    norm."""

    def __init__(self, cfg: BertConfig, gen=None, dropout_gen=None):
        super().__init__()
        self.attn = pnn.MultiHeadAttention(cfg.hidden_size, cfg.num_heads,
                                           dropout=cfg.dropout,
                                           use_flash=cfg.use_flash, gen=gen,
                                           dropout_gen=dropout_gen)
        self.ln1 = pnn.LayerNorm(cfg.hidden_size)
        self.fc1 = pnn.Linear(cfg.hidden_size, cfg.intermediate_size,
                              gen=gen)
        self.fc2 = pnn.Linear(cfg.intermediate_size, cfg.hidden_size,
                              gen=gen)
        self.ln2 = pnn.LayerNorm(cfg.hidden_size)
        self.drop = pnn.Dropout(cfg.dropout, gen=dropout_gen)

    def forward(self, x, mask=None):
        h = self.attn(x, mask=mask)
        x = self.ln1(self.drop(h), residual=x)
        h = pnn.fused_ffn(self.fc1, self.fc2, x)
        return self.ln2(self.drop(h), residual=x)


class BertEncoder(nn.Module):
    def __init__(self, cfg: BertConfig, gen=None, dropout_gen=None):
        super().__init__()
        self.cfg = cfg
        self.tok_emb = pnn.Embedding(cfg.vocab_size, cfg.hidden_size,
                                     gen=gen)
        self.pos_emb = pnn.Embedding(cfg.max_position, cfg.hidden_size,
                                     gen=gen)
        self.seg_emb = pnn.Embedding(cfg.type_vocab_size, cfg.hidden_size,
                                     gen=gen)
        self.emb_ln = pnn.LayerNorm(cfg.hidden_size)
        self.drop = pnn.Dropout(cfg.dropout, gen=dropout_gen)
        layers = [TransformerLayer(cfg, gen, dropout_gen)
                  for _ in range(cfg.num_layers)]
        if cfg.scan_layers:
            self.layers = pnn.ScanLayers(
                layers, remat=cfg.remat,
                gens=(dropout_gen,) if cfg.dropout > 0 else ())
        else:
            self.layers = nn.ModuleList(layers)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None):
        """``[B, T, H]`` hidden states. ``attention_mask`` ``[B, T]`` (1 =
        attend) becomes the ``[B, 1, 1, T]`` key-padding mask, which
        attention reduces to flash attention's ``kv_mask``."""
        _, t = input_ids.shape
        pos = torch.arange(t, device=input_ids.device)[None, :]
        x = self.tok_emb(input_ids) + self.pos_emb(pos)
        if token_type_ids is not None:
            x = x + self.seg_emb(token_type_ids)
        x = self.drop(self.emb_ln(x))
        mask = None
        if attention_mask is not None:
            mask = attention_mask[:, None, None, :]
        if self.cfg.scan_layers:
            return self.layers(x, mask=mask)
        for layer in self.layers:
            x = layer(x, mask=mask)
        return x


def _gather_positions(h, mask_positions):
    """``h[b, mask_positions[b, m]]`` -> ``[B, M, H]`` (the reference's
    ``take_along_axis``); None keeps every position."""
    if mask_positions is None:
        return h
    idx = mask_positions.long()[..., None].expand(-1, -1, h.shape[-1])
    return torch.gather(h, 1, idx)


class BertForPretraining(nn.Module):
    """MLM + NSP heads over the encoder (ref: ``models/bert.py:109``).
    Weights are drawn from ``seed`` on the CPU (so a seed gives the same
    weights on every machine) and moved to ``device``, which defaults to
    the card and raises when there is none. Dropout masks come from
    ``dropout_gen``, a generator on ``device`` seeded with ``seed``."""

    def __init__(self, cfg: BertConfig, device="cuda", seed=0):
        super().__init__()
        cfg.check_ported()
        dev = resolve_device(device)
        self.cfg = cfg
        gen = torch.Generator().manual_seed(seed)
        self.dropout_gen = torch.Generator(device=dev).manual_seed(seed)
        self.encoder = BertEncoder(cfg, gen, self.dropout_gen)
        self.mlm_transform = pnn.Linear(cfg.hidden_size, cfg.hidden_size,
                                        act="gelu", gen=gen)
        self.mlm_ln = pnn.LayerNorm(cfg.hidden_size)
        self.mlm_bias = nn.Parameter(torch.zeros(cfg.vocab_size))
        self.pooler = pnn.Linear(cfg.hidden_size, cfg.hidden_size,
                                 act="tanh", gen=gen)
        self.nsp = pnn.Linear(cfg.hidden_size, 2, gen=gen)
        self.to(dev)

    @property
    def device(self):
        return self.mlm_bias.device

    def _mlm_hidden(self, h, mask_positions):
        return self.mlm_ln(self.mlm_transform(
            _gather_positions(h, mask_positions)))

    def forward(self, input_ids, token_type_ids=None, attention_mask=None,
                mask_positions=None):
        """``(mlm_logits, nsp_logits)``. ``mask_positions`` ``[B, M]``
        gathers the masked positions before the MLM head, so the logits
        are ``[B, M, V]``; None keeps ``[B, T, V]``."""
        h = self.encoder(input_ids, token_type_ids, attention_mask)
        mlm_logits = (pnn.tied_vocab_head(
            self.encoder.tok_emb, self._mlm_hidden(h, mask_positions))
            + self.mlm_bias)
        nsp_logits = self.nsp(self.pooler(h[:, 0]))
        return mlm_logits, nsp_logits

    def loss(self, input_ids, mlm_labels, nsp_labels, mlm_mask,
             token_type_ids=None, attention_mask=None, mask_positions=None,
             vocab_axis=None, batch_axis=None, mesh=None, mesh_plan=None):
        """The MLM + NSP pretraining loss, a scalar f32 (ref:
        ``models/bert.py:143``): the MLM vocab projection fused into the
        cross-entropy against the tied embedding and ``mlm_bias`` (K5
        forward, K6 backward on the card), so no ``[B, M, V]`` logits
        exist; the masked mean over ``mlm_mask`` plus the mean NSP
        cross-entropy. Over an int8 table it is :func:`pretrain_loss` of
        the logits, as in the reference. The vocab-sharded loss waits for
        multi-GPU."""
        if any(a is not None for a in (vocab_axis, batch_axis, mesh,
                                        mesh_plan)):
            raise NotImplementedError(
                "BertForPretraining.loss: the vocab-sharded loss "
                "(vocab_axis, batch_axis, mesh, mesh_plan) is not ported")
        if is_int8(self.encoder.tok_emb):
            mlm_logits, nsp_logits = self.forward(
                input_ids, token_type_ids, attention_mask, mask_positions)
            return pretrain_loss(mlm_logits, nsp_logits, mlm_labels,
                                 nsp_labels, mlm_mask)
        h = self.encoder(input_ids, token_type_ids, attention_mask)
        ce = fused_xent(self._mlm_hidden(h, mask_positions),
                        self.encoder.tok_emb.weight, mlm_labels,
                        bias=self.mlm_bias)
        mlm = (ce * mlm_mask).sum() / torch.clamp(mlm_mask.sum(), min=1)
        nsp_logits = self.nsp(self.pooler(h[:, 0]))
        nsp = softmax_with_cross_entropy(nsp_logits,
                                         nsp_labels[..., None]).mean()
        return mlm + nsp


def pretrain_loss(mlm_logits, nsp_logits, mlm_labels, nsp_labels,
                  mlm_mask):
    """Masked-LM + NSP loss of materialized logits; ``mlm_mask`` is 1.0 at
    the masked positions. The parity composition for
    :meth:`BertForPretraining.loss` (ref: ``models/bert.py:183``)."""
    mlm = softmax_with_cross_entropy(mlm_logits, mlm_labels[..., None])
    mlm = (mlm[..., 0] * mlm_mask).sum() / torch.clamp(mlm_mask.sum(), min=1)
    nsp = softmax_with_cross_entropy(nsp_logits,
                                     nsp_labels[..., None]).mean()
    return mlm + nsp
