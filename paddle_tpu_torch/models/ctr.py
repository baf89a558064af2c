"""CTR models: DeepFM and Wide&Deep, the sparse-embedding flagship (ref:
``paddle_tpu/models/ctr.py``).

Parameter names are the reference's (``embed.weight``,
``fm_linear.weight``, ``dense_linear.{weight,bias}``,
``dnn.<i>.{weight,bias}``, ``dnn_out.*``; Wide&Deep's ``wide.weight`` and
``wide_dense.*``), so ``bridge.load_params`` copies them as they are.
Weights are drawn from ``seed`` on the CPU and moved to ``device`` (the
card by default; raises without one).

With ``DeepFM(cfg, sparse_tables=True)`` the two embedding tables are not
parameters: they live in ``parallel/sparse.py`` tables and
:func:`make_sparse_deepfm_train_step` drives the model through
:meth:`DeepFM.forward_from_emb` with the pulled rows.
"""

import dataclasses

import torch
from torch import nn

from paddle_tpu_torch import initializer as I
from paddle_tpu_torch import nn as pnn
from paddle_tpu_torch.core.device import resolve_device
from paddle_tpu_torch.core.enforce import EnforceError
from paddle_tpu_torch.ops.loss import sigmoid_cross_entropy_with_logits


@dataclasses.dataclass
class CTRConfig:
    """ref: ``ctr.py:25``; ``vocab_size`` is the hash size of one field."""

    num_sparse_fields: int = 26
    num_dense_fields: int = 13
    vocab_size: int = 10000
    embed_dim: int = 16
    hidden: tuple = (400, 400, 400)

    @staticmethod
    def tiny():
        return CTRConfig(num_sparse_fields=4, num_dense_fields=3,
                         vocab_size=100, embed_dim=8, hidden=(32, 16))

    @property
    def total_vocab(self):
        """Rows of the one table shared by every field (ids offset by
        ``field * vocab_size``)."""
        return self.vocab_size * self.num_sparse_fields


def _offset_ids(cfg, sparse_ids):
    """Per-field ids ``[B, F]`` as rows of the shared table."""
    offsets = torch.arange(cfg.num_sparse_fields,
                           device=sparse_ids.device) * cfg.vocab_size
    return sparse_ids.long() + offsets[None, :]


def _dnn(cfg, gen):
    """The relu MLP over ``[B, F * K + D_dense]`` and its 1-wide output."""
    dnn_in = cfg.num_sparse_fields * cfg.embed_dim + cfg.num_dense_fields
    layers = []
    for h in cfg.hidden:
        layers.append(pnn.Linear(dnn_in, h, act="relu", gen=gen))
        dnn_in = h
    return nn.Sequential(*layers), pnn.Linear(dnn_in, 1, gen=gen)


class DeepFM(nn.Module):
    """FM (first and second order) plus a DNN over shared embeddings (ref:
    ``ctr.py:38``)."""

    def __init__(self, cfg: CTRConfig, sparse_tables=False, device="cuda",
                 seed=0):
        super().__init__()
        dev = resolve_device(device)
        gen = torch.Generator().manual_seed(seed)
        self.cfg = cfg
        self.sparse_tables = sparse_tables
        if not sparse_tables:
            self.embed = pnn.Embedding(cfg.total_vocab, cfg.embed_dim,
                                       weight_init=I.normal(0, 0.01),
                                       gen=gen)
            self.fm_linear = pnn.Embedding(cfg.total_vocab, 1,
                                           weight_init=I.zeros(), gen=gen)
        self.dense_linear = pnn.Linear(cfg.num_dense_fields, 1, gen=gen)
        self.dnn, self.dnn_out = _dnn(cfg, gen)
        self.to(dev)

    def forward(self, dense, sparse_ids):
        """dense ``[B, D_dense]``, sparse_ids ``[B, F]`` per-field ids ->
        logits ``[B, 1]``."""
        if self.sparse_tables:
            raise EnforceError(
                "DeepFM(sparse_tables=True) has no embedding tables of its "
                "own; call forward_from_emb with rows pulled from a "
                "SparseTable/HostTable (see make_sparse_deepfm_train_step)")
        ids = _offset_ids(self.cfg, sparse_ids)
        return self.forward_from_emb(dense, self.embed(ids),
                                     self.fm_linear(ids))

    def forward_from_emb(self, dense, emb, first_order):
        """The head over pulled embeddings ``emb [B, F, K]`` and first-order
        weights ``first_order [B, F, 1]``."""
        first = first_order.sum(dim=(1, 2))[:, None] + self.dense_linear(
            dense)
        # second order: 0.5 * ((sum v)^2 - sum v^2)
        sum_v = emb.sum(dim=1)
        sum_sq = torch.square(emb).sum(dim=1)
        second = 0.5 * (torch.square(sum_v) - sum_sq).sum(dim=1,
                                                          keepdim=True)
        flat = torch.cat([emb.reshape(emb.shape[0], -1), dense], dim=1)
        deep = self.dnn_out(self.dnn(flat))
        return first + second + deep


class WideAndDeep(nn.Module):
    """A linear wide part plus a DNN deep part (ref: ``ctr.py:106``)."""

    def __init__(self, cfg: CTRConfig, device="cuda", seed=0):
        super().__init__()
        dev = resolve_device(device)
        gen = torch.Generator().manual_seed(seed)
        self.cfg = cfg
        self.wide = pnn.Embedding(cfg.total_vocab, 1, weight_init=I.zeros(),
                                  gen=gen)
        self.wide_dense = pnn.Linear(cfg.num_dense_fields, 1, gen=gen)
        self.embed = pnn.Embedding(cfg.total_vocab, cfg.embed_dim,
                                   weight_init=I.normal(0, 0.01), gen=gen)
        self.dnn, self.dnn_out = _dnn(cfg, gen)
        self.to(dev)

    def forward(self, dense, sparse_ids):
        ids = _offset_ids(self.cfg, sparse_ids)
        wide = self.wide(ids).sum(dim=(1, 2))[:, None] + self.wide_dense(
            dense)
        emb = self.embed(ids).reshape(ids.shape[0], -1)
        deep = self.dnn_out(self.dnn(torch.cat([emb, dense], dim=1)))
        return wide + deep


def ctr_loss(logits, labels):
    """Mean sigmoid cross entropy (ref: ``ctr.py:136``)."""
    return sigmoid_cross_entropy_with_logits(logits, labels).mean()


def make_sparse_deepfm_train_step(model, opt, embed_tbl, linear_tbl,
                                  embed_state, linear_state):
    """Sparse-row DeepFM training (ref: ``ctr.py:142``, DownpourWorker's
    pull, train, push): ``model`` is ``DeepFM(cfg, sparse_tables=True)``,
    ``opt`` an optimizer of its parameters, ``embed_tbl``/``linear_tbl``
    :class:`~paddle_tpu_torch.parallel.sparse.SparseTable` s of ``[V*F,
    K]`` and ``[V*F, 1]`` with their states. Returns

        step(dense, sparse_ids, labels) -> loss

    which pulls the batch's unique rows from both tables, runs the loss
    through them, steps ``opt`` on the head and pushes the row gradients,
    updating the model, ``opt`` and both table states in place (the
    reference's functional step returns them instead). Only the unique
    rows enter the autograd graph."""
    cfg = model.cfg

    def step(dense, sparse_ids, labels):
        ids = _offset_ids(cfg, sparse_ids)
        erows, ectx = embed_tbl.pull(embed_state, ids)
        lrows, lctx = linear_tbl.pull(linear_state, ids)
        erows.requires_grad_(True)
        lrows.requires_grad_(True)

        def loss_fn(m):
            logits = m.forward_from_emb(dense, embed_tbl.embed(erows, ectx),
                                        linear_tbl.embed(lrows, lctx))
            return ctr_loss(logits, labels)

        loss = opt.minimize(model, loss_fn)
        embed_tbl.push(embed_state, erows.grad, ectx)
        linear_tbl.push(linear_state, lrows.grad, lctx)
        return loss

    return step
