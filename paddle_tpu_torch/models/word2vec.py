"""word2vec (ref: ``paddle_tpu/models/word2vec.py``): the book's N-gram
language model (:class:`Word2Vec`: the context words' embeddings
concatenated -> sigmoid fc -> logits over the vocabulary) and the
skip-gram trained with NCE (:class:`SkipGramNCE`, over ``ops/loss.py``'s
``nce_loss``). Weights are drawn from ``seed`` on the CPU and moved to
``device`` (the card by default; raises without one); parameter names
are the reference's (``embed.weight``, ``fc1.weight``, ``nce_weight``,
``nce_bias``), so ``bridge.load_params`` copies a JAX tree as it is. No
kernel of the port runs on either model."""

import torch
from torch import nn

from paddle_tpu_torch import initializer as I
from paddle_tpu_torch import nn as pnn
from paddle_tpu_torch.core.device import resolve_device
from paddle_tpu_torch.ops.loss import (nce_loss_from, nce_negatives,
                                      softmax_with_cross_entropy)


class Word2Vec(nn.Module):
    """ref: ``word2vec.py:16``."""

    def __init__(self, vocab_size=2048, embed_dim=32, context=4,
                 hidden=256, device="cuda", seed=0):
        super().__init__()
        dev = resolve_device(device)
        gen = torch.Generator().manual_seed(seed)
        self.vocab_size = vocab_size
        self.embed = pnn.Embedding(
            vocab_size, embed_dim, gen=gen,
            weight_init=I.uniform(-0.5 / embed_dim, 0.5 / embed_dim))
        self.fc1 = pnn.Linear(context * embed_dim, hidden, act="sigmoid",
                              gen=gen)
        self.fc2 = pnn.Linear(hidden, vocab_size, gen=gen)
        self.to(dev)

    def forward(self, context_ids):
        """``context_ids [B, C]`` -> logits ``[B, V]``."""
        e = self.embed(context_ids)
        return self.fc2(self.fc1(e.reshape(e.shape[0], -1)))


def lm_loss(logits, labels):
    return softmax_with_cross_entropy(logits, labels).mean()


class SkipGramNCE(nn.Module):
    """ref: ``word2vec.py:41`` — the center word's embedding scored by NCE
    against its target and ``num_neg`` negatives drawn uniformly over the
    vocabulary. The draw is split from the loss: the negatives come from
    the model's own generator (``self.gen``, on the model's device, seeded
    from ``seed``; the reference's ``rngs={"nce": key}``) unless the
    caller passes ``neg`` ``[B, num_neg]``, which is how a test feeds the
    reference's draw. ``forward`` returns the per-row loss ``[B, 1]``."""

    def __init__(self, vocab_size=2048, embed_dim=64, num_neg=16,
                 device="cuda", seed=0):
        super().__init__()
        dev = resolve_device(device)
        gen = torch.Generator().manual_seed(seed)
        self.vocab_size = vocab_size
        self.num_neg = num_neg
        self.embed = pnn.Embedding(vocab_size, embed_dim, gen=gen,
                                   weight_init=I.uniform(-0.05, 0.05))
        self.nce_weight = nn.Parameter(I.normal(0.0, 0.01)(
            (vocab_size, embed_dim), gen))
        self.nce_bias = nn.Parameter(torch.zeros(vocab_size))
        self.to(dev)
        self.gen = torch.Generator(device=dev).manual_seed(seed)

    def negatives(self, batch):
        """``[batch, num_neg]`` negatives from the model's generator."""
        return nce_negatives(self.gen, batch, self.num_neg, self.vocab_size)

    def forward(self, center_ids, target_ids, neg=None):
        h = self.embed(center_ids)                          # [B, D]
        if neg is None:
            neg = self.negatives(h.shape[0])
        return nce_loss_from(h, target_ids, self.nce_weight, self.nce_bias,
                             neg, self.vocab_size)
