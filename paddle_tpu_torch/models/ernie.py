"""ERNIE 1.0 — knowledge-masked BERT pretraining, the port of
``paddle_tpu/models/ernie.py``.

The network is BERT's (:class:`ErnieForPretraining` is
:class:`BertForPretraining` under another config); what makes it ERNIE is
the data: :func:`knowledge_mask` masks whole phrases and entities as
units. It is a host-side numpy transform, copied here so that the port
imports nothing of the JAX package; given the same seed it gives the same
arrays as the reference's.
"""

import dataclasses

import numpy as np

from paddle_tpu_torch.models.bert import (BertConfig, BertForPretraining,
                                          pretrain_loss)


@dataclasses.dataclass
class ErnieConfig(BertConfig):
    """ERNIE 1.0 base: BERT-base dims over an 18k Chinese vocab."""
    vocab_size: int = 18000

    @staticmethod
    def base():
        return ErnieConfig()

    @staticmethod
    def tiny():
        return ErnieConfig(vocab_size=512, hidden_size=64, num_layers=2,
                           num_heads=4, intermediate_size=128,
                           max_position=64)


class ErnieForPretraining(BertForPretraining):
    """BERT's MLM + sentence-pair heads; the knowledge masking happens in
    the data pipeline (:func:`knowledge_mask`)."""


ernie_pretrain_loss = pretrain_loss


def knowledge_mask(ids, spans, mask_id, vocab_size, mask_prob=0.15,
                   seed=0, pad_id=0):
    """Span-level knowledge masking (ref: ``models/ernie.py:59``).

    ids ``[B, T]`` int; spans, per example, ``(start, end)`` half-open
    phrase/entity units; positions outside every span are single-token
    units (pads excepted). Each unit is selected with probability
    ``mask_prob`` and masked as a whole: 80 % ``mask_id``, 10 % random
    ids, 10 % unchanged. Returns ``(masked_ids, mlm_labels,
    mlm_weights)``: labels are the original ids, weights 1.0 on masked
    positions."""
    ids = np.asarray(ids)
    b_, t_ = ids.shape
    rng = np.random.RandomState(seed)
    masked = ids.copy()
    weights = np.zeros((b_, t_), np.float32)
    for b in range(b_):
        covered = np.zeros(t_, bool)
        units = []
        for s, e in spans[b] if b < len(spans) else []:
            s, e = max(0, int(s)), min(t_, int(e))
            if e > s:
                units.append((s, e))
                covered[s:e] = True
        for t in range(t_):
            if not covered[t] and ids[b, t] != pad_id:
                units.append((t, t + 1))
        for s, e in units:
            if rng.random_sample() >= mask_prob:
                continue
            weights[b, s:e] = 1.0
            r = rng.random_sample()
            if r < 0.8:
                masked[b, s:e] = mask_id
            elif r < 0.9:
                masked[b, s:e] = rng.randint(0, vocab_size, e - s)
    return masked, ids, weights
