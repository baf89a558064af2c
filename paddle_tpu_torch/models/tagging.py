"""The BiLSTM-CRF sequence tagger, the book's label_semantic_roles model
(ref: ``paddle_tpu/models/tagging.py``): word (and optional extra
feature) embeddings -> stacked bidirectional LSTM -> per-tag emissions ->
linear-chain CRF cost, Viterbi decoding at inference. Padded ``[B, T]``
batches with lengths. Weights are drawn from ``seed`` on the CPU and moved
to ``device`` (the card by default; raises without one); dropout masks
come from ``dropout_gen``, a generator on ``device``.
"""

import dataclasses

import torch
from torch import nn

from paddle_tpu_torch import initializer as I
from paddle_tpu_torch import nn as pnn
from paddle_tpu_torch.core.device import resolve_device
from paddle_tpu_torch.ops import crf as C


@dataclasses.dataclass
class TaggerConfig:
    vocab_size: int = 4096
    num_tags: int = 16
    embed_dim: int = 32
    hidden: int = 64
    num_lstm_layers: int = 2      # ref uses depth 8 stacked bi-LSTM
    num_extra_features: int = 0   # e.g. predicate/context marks (SRL)
    dropout: float = 0.0

    @staticmethod
    def tiny():
        return TaggerConfig(vocab_size=64, num_tags=5, embed_dim=8, hidden=16,
                            num_lstm_layers=1)


class BiLstmCrfTagger(nn.Module):
    """ref: ``tagging.py:36``. Parameters carry the reference's names:
    ``embed.weight``, ``extra_embeds.<i>.weight``, ``lstm.w_ih_l0d0`` ...,
    ``emission.weight``/``bias`` and ``transition`` ``[K + 2, K]`` (row 0
    start, row 1 stop)."""

    def __init__(self, cfg: TaggerConfig, device="cuda", seed=0):
        super().__init__()
        dev = resolve_device(device)
        gen = torch.Generator().manual_seed(seed)
        self.dropout_gen = torch.Generator(device=dev).manual_seed(seed)
        self.cfg = cfg
        self.embed = pnn.Embedding(cfg.vocab_size, cfg.embed_dim, gen=gen)
        if cfg.num_extra_features:
            self.extra_embeds = nn.ModuleList(
                pnn.Embedding(cfg.vocab_size, cfg.embed_dim, gen=gen)
                for _ in range(cfg.num_extra_features))
        in_dim = cfg.embed_dim * (1 + cfg.num_extra_features)
        self.lstm = pnn.LSTM(in_dim, cfg.hidden,
                             num_layers=cfg.num_lstm_layers,
                             bidirectional=True, gen=gen)
        self.emission = pnn.Linear(cfg.hidden * 2, cfg.num_tags, gen=gen)
        self.transition = nn.Parameter(I.uniform(-0.1, 0.1)(
            (cfg.num_tags + 2, cfg.num_tags), gen, torch.float32))
        self.dropout = pnn.Dropout(cfg.dropout, gen=self.dropout_gen)
        self.to(dev)

    @property
    def device(self):
        return self.transition.device

    def emissions(self, token_ids, lengths, extra_ids=None):
        """Per-tag scores ``[B, T, K]``."""
        emb = self.embed(token_ids)
        if self.cfg.num_extra_features:
            emb = torch.cat([emb] + [e(extra_ids[..., i]) for i, e in
                                     enumerate(self.extra_embeds)], -1)
        out, _ = self.lstm(self.dropout(emb), lengths=lengths)
        return self.emission(out)

    def forward(self, token_ids, lengths, labels=None, extra_ids=None):
        """With ``labels``: the mean CRF negative log-likelihood (the
        training cost). Without: the Viterbi paths ``[B, T]`` int32."""
        em = self.emissions(token_ids, lengths, extra_ids)
        if labels is not None:
            return C.linear_chain_crf(em, self.transition, labels,
                                      lengths).mean()
        return C.crf_decoding(em, self.transition, lengths)
