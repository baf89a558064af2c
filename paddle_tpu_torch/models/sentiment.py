"""Sentiment classification, the book's understand_sentiment nets (ref:
``paddle_tpu/models/sentiment.py``): the text-CNN (two centred
context-window projections max-pooled over time) and the stacked LSTM net
(fc + LSTM stacks of alternating direction, max-pooled). Padded ``[B, T]``
batches with lengths. Weights are drawn from ``seed`` on the CPU and moved
to ``device`` (the card by default; raises without one).

Pooling over time masks the padding with the dtype's lowest value and
takes ``torch.amax``, whose gradient splits a tie equally as ``jnp.max``'s
does (``torch.max(dim)`` sends it all to one index).
"""

import dataclasses

import torch
from torch import nn

from paddle_tpu_torch import initializer as I
from paddle_tpu_torch import nn as pnn
from paddle_tpu_torch.core.device import resolve_device
from paddle_tpu_torch.ops import rnn as R
from paddle_tpu_torch.ops.loss import softmax_with_cross_entropy


@dataclasses.dataclass
class SentimentConfig:
    vocab_size: int = 5149        # imdb word dict size in the book fixture
    embed_dim: int = 128
    hidden: int = 128
    num_classes: int = 2
    window: int = 3

    @staticmethod
    def tiny():
        return SentimentConfig(vocab_size=200, embed_dim=16, hidden=16)


def _valid(ids, lengths):
    """``(lengths, mask [B, T])``; no lengths means every row is full."""
    B, T = ids.shape
    if lengths is None:
        lengths = torch.full((B,), T, dtype=torch.int32, device=ids.device)
    return lengths, (torch.arange(T, device=ids.device)[None, :]
                     < lengths[:, None])


def _masked_max(h, mask):
    """Max over time of ``h [B, T, D]`` with the padding at the dtype's
    lowest value."""
    low = torch.finfo(h.dtype).min
    return torch.amax(torch.where(mask[..., None], h, low), 1)


class TextCNNSentiment(nn.Module):
    """convolution_net (ref: ``sentiment.py:34``): embedding -> width-3
    and width-4 window projections (tanh), each max-pooled -> fc."""

    def __init__(self, cfg: SentimentConfig, device="cuda", seed=0):
        super().__init__()
        dev = resolve_device(device)
        gen = torch.Generator().manual_seed(seed)
        self.cfg = cfg
        self.embed = pnn.Embedding(cfg.vocab_size, cfg.embed_dim, gen=gen,
                                   weight_init=I.normal(0, 0.1))
        # a window convolution is a Linear over the concatenated window
        self.conv3 = pnn.Linear(3 * cfg.embed_dim, cfg.hidden, act="tanh",
                                gen=gen)
        self.conv4 = pnn.Linear(4 * cfg.embed_dim, cfg.hidden, act="tanh",
                                gen=gen)
        self.fc = pnn.Linear(2 * cfg.hidden, cfg.num_classes, gen=gen)
        self.to(dev)

    def _window_pool(self, emb, mask, width, proj):
        """The centred ``width``-token windows (``sequence_conv``'s
        convention, ``context_start = -(width - 1) // 2``) projected, then
        max-pooled over the valid positions. A window reads 0 outside
        ``[0, T)``; the padding's embeddings are 0 already."""
        T = emb.shape[1]
        pos0 = torch.arange(T, device=emb.device)
        start = -((width - 1) // 2)
        cols = []
        for k in range(width):
            off = start + k
            pos = pos0 + off
            ok = (pos >= 0) & (pos < T)
            cols.append(torch.where(ok[None, :, None],
                                    torch.roll(emb, -off, dims=1), 0.0))
        return _masked_max(proj(torch.cat(cols, -1)), mask)

    def forward(self, ids, lengths=None):
        lengths, mask = _valid(ids, lengths)
        emb = self.embed(ids) * mask[..., None]
        a = self._window_pool(emb, mask, 3, self.conv3)
        b = self._window_pool(emb, mask, 4, self.conv4)
        return self.fc(torch.cat([a, b], -1))


class _DirLSTM(nn.Module):
    """One LSTM of a fixed direction (the book's ``is_reverse``):
    ``w_ih`` ``[I, 4H]``, ``w_hh`` ``[H, 4H]`` (xavier), ``b`` ``[4H]``."""

    def __init__(self, input_size, hidden_size, reverse=False, gen=None,
                 dtype=torch.float32):
        super().__init__()
        self.hidden_size = hidden_size
        self.reverse = reverse
        self.w_ih = nn.Parameter(I.xavier()((input_size, 4 * hidden_size),
                                            gen, dtype))
        self.w_hh = nn.Parameter(I.xavier()((hidden_size, 4 * hidden_size),
                                            gen, dtype))
        self.b = nn.Parameter(torch.zeros(4 * hidden_size, dtype=dtype))

    def forward(self, x, lengths=None):
        h0 = torch.zeros((x.shape[0], self.hidden_size), dtype=x.dtype,
                         device=x.device)
        outs, _ = R.lstm(x, h0, torch.zeros_like(h0), self.w_ih, self.w_hh,
                         self.b, lengths=lengths, reverse=self.reverse)
        return outs


class StackedLSTMSentiment(nn.Module):
    """stacked_lstm_net (ref: ``sentiment.py:101``): embedding ->
    ``stacked_num`` (fc -> LSTM) stacks, every second one reversed ->
    the last LSTM's and the last fc's outputs max-pooled -> fc."""

    def __init__(self, cfg: SentimentConfig, stacked_num=3, device="cuda",
                 seed=0):
        super().__init__()
        dev = resolve_device(device)
        gen = torch.Generator().manual_seed(seed)
        self.cfg = cfg
        self.stacked_num = stacked_num
        self.embed = pnn.Embedding(cfg.vocab_size, cfg.embed_dim, gen=gen,
                                   weight_init=I.normal(0, 0.1))
        self.fcs = nn.ModuleList(
            pnn.Linear(cfg.embed_dim if i == 0 else cfg.hidden, cfg.hidden,
                       gen=gen) for i in range(stacked_num))
        self.lstms = nn.ModuleList(
            _DirLSTM(cfg.hidden, cfg.hidden, reverse=bool(i % 2), gen=gen)
            for i in range(stacked_num))
        self.out = pnn.Linear(2 * cfg.hidden, cfg.num_classes, gen=gen)
        self.to(dev)

    def forward(self, ids, lengths=None):
        lengths, mask = _valid(ids, lengths)
        h = self.embed(ids) * mask[..., None]
        for fc, lstm in zip(self.fcs, self.lstms):
            f = fc(h)
            h = lstm(f, lengths=lengths)
        return self.out(torch.cat([_masked_max(h, mask),
                                   _masked_max(f, mask)], -1))


def sentiment_loss(logits, labels):
    return softmax_with_cross_entropy(logits, labels).mean()
