"""word2vec's N-gram language model (ref: ``paddle_tpu/models/word2vec.py``,
the book's test_word2vec network): the context words' embeddings
concatenated -> sigmoid fc -> logits over the vocabulary. Weights are
drawn from ``seed`` on the CPU and moved to ``device`` (the card by
default; raises without one). The reference's ``SkipGramNCE`` waits for
``nce_loss``."""

import torch
from torch import nn

from paddle_tpu_torch import initializer as I
from paddle_tpu_torch import nn as pnn
from paddle_tpu_torch.core.device import resolve_device
from paddle_tpu_torch.ops.loss import softmax_with_cross_entropy


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
