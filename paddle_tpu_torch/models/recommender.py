"""The recommender_system book model (ref:
``paddle_tpu/models/recommender.py``): a user tower (id, gender, age and
job embeddings -> tanh fc) and a movie tower (id embedding, the masked
mean of its category embeddings and the masked max of its title's ->
tanh fc), joined by a cosine scaled to the 5-point rating. Weights are
drawn from ``seed`` on the CPU and moved to ``device`` (the card by
default; raises without one)."""

import dataclasses

import torch
from torch import nn

from paddle_tpu_torch import nn as pnn
from paddle_tpu_torch.core.device import resolve_device


@dataclasses.dataclass
class RecConfig:
    num_users: int = 256
    num_genders: int = 2
    num_ages: int = 8
    num_jobs: int = 32
    num_movies: int = 512
    num_categories: int = 32
    title_vocab: int = 1024
    embed_dim: int = 32
    fc_dim: int = 64

    @staticmethod
    def tiny():
        return RecConfig(num_users=16, num_movies=32, num_categories=8,
                         title_vocab=64, embed_dim=8, fc_dim=16)


class RecommenderNet(nn.Module):
    """Twin-tower rating regressor: ``5 * cosine(user, movie)`` (ref:
    ``recommender.py:36``)."""

    def __init__(self, cfg: RecConfig, device="cuda", seed=0):
        super().__init__()
        dev = resolve_device(device)
        gen = torch.Generator().manual_seed(seed)
        self.cfg = cfg
        E, F = cfg.embed_dim, cfg.fc_dim
        self.usr_emb = pnn.Embedding(cfg.num_users, E, gen=gen)
        self.gender_emb = pnn.Embedding(cfg.num_genders, E // 2, gen=gen)
        self.age_emb = pnn.Embedding(cfg.num_ages, E // 2, gen=gen)
        self.job_emb = pnn.Embedding(cfg.num_jobs, E // 2, gen=gen)
        self.usr_fc = pnn.Linear(E + 3 * (E // 2), F, act="tanh", gen=gen)
        self.mov_emb = pnn.Embedding(cfg.num_movies, E, gen=gen)
        self.cat_emb = pnn.Embedding(cfg.num_categories, E // 2, gen=gen)
        self.title_emb = pnn.Embedding(cfg.title_vocab, E, gen=gen)
        self.mov_fc = pnn.Linear(E + E // 2 + E, F, act="tanh", gen=gen)
        self.to(dev)

    def forward(self, usr_id, gender, age, job, mov_id, categories,
                cat_mask, title_ids, title_mask):
        """``categories``/``title_ids``: ``[B, L]`` padded id sequences
        with 0/1 float masks (the reference pools LoD sequences; here a
        masked mean and a masked max). Returns the rating ``[B]``."""
        u = self.usr_fc(torch.cat([
            self.usr_emb(usr_id), self.gender_emb(gender),
            self.age_emb(age), self.job_emb(job)], dim=-1))
        cat = (self.cat_emb(categories) * cat_mask[..., None]).sum(1) / \
            torch.clamp(cat_mask.sum(1, keepdim=True), min=1.0)
        title = torch.amax(
            self.title_emb(title_ids) * title_mask[..., None]
            + (title_mask[..., None] - 1.0) * 1e9, dim=1)
        # a row with no title tokens pools to zeros instead of -1e9
        has_title = title_mask.sum(1, keepdim=True) > 0
        title = torch.where(has_title, title, torch.zeros_like(title))
        m = self.mov_fc(torch.cat([self.mov_emb(mov_id), cat, title],
                                  dim=-1))
        cos = (u * m).sum(-1) / torch.clamp(
            torch.linalg.vector_norm(u, dim=-1)
            * torch.linalg.vector_norm(m, dim=-1), min=1e-8)
        return 5.0 * cos


def rating_loss(pred, rating):
    return torch.mean((pred - rating) ** 2)
