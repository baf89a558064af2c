"""Mixture-of-Experts FFN on one device (ref: ``paddle_tpu/nn/moe.py``).

Static shapes throughout, as in the reference: top-k softmax gating with
the Switch/GShard load-balancing aux loss, written as dense ``[T, E]``
one-hots; capacity ``C = ceil(k * T * capacity_factor / E)``; a token
past its expert's capacity is dropped (combine weight 0); dispatch and
combine are ``[T, E, C]`` one-hot einsums around the experts' FFNs.

The arithmetic is the reference's, types included: the slot of a token is
a ``cumsum`` of one-hots in the gating's dtype, so under the bf16 policy
slot indices above 256 round and two tokens can share a slot, in both
packages. Expert parallelism (``ep_axis``: one all_to_all pair per layer
over a mesh) needs several GPUs and raises ``NotImplementedError``.
"""

import math

import torch
from torch import nn

from paddle_tpu_torch import initializer as I
from paddle_tpu_torch.core.enforce import enforce
from paddle_tpu_torch.ops import activations as A
from paddle_tpu_torch.ops import nn as F


def _one_hot(idx, n, dtype):
    return nn.functional.one_hot(idx.long(), n).to(dtype)


def _einsum(eq, a, b):
    """``torch.einsum`` with jnp's promotion of two floating types."""
    if a.dtype != b.dtype:
        dt = torch.result_type(a, b)
        a, b = a.to(dt), b.to(dt)
    return torch.einsum(eq, a, b)


def top_k_gating(logits, k, capacity):
    """Static-shape top-k gating of ``logits`` ``[T, E]`` (ref:
    ``nn/moe.py:30``): ``(dispatch [T, E, C] one-hot, combine [T, E, C]
    weights, aux scalar)``. A token's slot in its expert's buffer is its
    rank among the tokens routed there (``cumsum`` order), the second
    choices packed after the first; slots ``>= capacity`` get weight 0."""
    t, e = logits.shape
    probs = torch.softmax(logits, dim=-1)
    dt = probs.dtype
    dispatch = torch.zeros((t, e, capacity), dtype=dt, device=logits.device)
    combine = torch.zeros_like(dispatch)
    occupancy = torch.zeros(e, dtype=torch.int32, device=logits.device)
    masked = probs
    for _ in range(k):
        onehot = _one_hot(torch.argmax(masked, dim=-1), e, dt)
        pos_in_round = torch.cumsum(onehot, dim=0) - onehot
        pos = (pos_in_round + occupancy[None, :]) * onehot
        pos_idx = pos.sum(dim=-1).to(torch.int32)
        keep = pos_idx < capacity
        gate = (probs * onehot).sum(dim=-1) * keep
        pos_oh = _one_hot(torch.where(keep, pos_idx,
                                      torch.full_like(pos_idx, capacity)),
                          capacity + 1, dt)[:, :capacity]
        dispatch = dispatch + onehot[:, :, None] * pos_oh[:, None, :]
        combine = combine + (gate[:, None, None] * onehot[:, :, None]
                             * pos_oh[:, None, :])
        occupancy = occupancy + onehot.sum(dim=0).to(torch.int32)
        masked = masked * (1.0 - onehot)
    # Switch Transformer eq. 4: E * sum_e f_e * p_e
    first = _one_hot(torch.argmax(probs, dim=-1), e, dt)
    aux = e * (first.mean(dim=0) * probs.mean(dim=0)).sum()
    return dispatch, combine, aux


class MoE(nn.Module):
    """Top-k routed expert FFN, ``[B, T, D] -> [B, T, D]`` (ref:
    ``nn/moe.py:86``). Parameters ``w_gate [D, E]`` (xavier), ``w1 [E, D,
    H]`` and ``w2 [E, H, D]`` (xavier with the per-expert fans), zero
    ``b1 [E, H]`` and ``b2 [E, D]``. The experts' gelu is ``jax.nn.gelu``'s
    default, the tanh approximation."""

    def __init__(self, dim, hidden, num_experts, k=2, capacity_factor=1.25,
                 ep_axis=None, gen=None, dtype=torch.float32):
        super().__init__()
        enforce(k <= num_experts, "MoE top-k needs k <= num_experts")
        if ep_axis is not None:
            raise NotImplementedError(
                "MoE ep_axis (expert parallelism over a mesh) needs "
                "several GPUs and is not ported")
        self.dim, self.hidden = dim, hidden
        self.num_experts, self.k = num_experts, k
        self.capacity_factor = capacity_factor
        self.w_gate = nn.Parameter(I.xavier()((dim, num_experts), gen,
                                              dtype))
        self.w1 = nn.Parameter(I.xavier(fan_in=dim, fan_out=hidden)(
            (num_experts, dim, hidden), gen, dtype))
        self.b1 = nn.Parameter(torch.zeros(num_experts, hidden, dtype=dtype))
        self.w2 = nn.Parameter(I.xavier(fan_in=hidden, fan_out=dim)(
            (num_experts, hidden, dim), gen, dtype))
        self.b2 = nn.Parameter(torch.zeros(num_experts, dim, dtype=dtype))

    def capacity(self, tokens):
        return max(math.ceil(self.k * tokens * self.capacity_factor
                             / self.num_experts), 1)

    def forward(self, x):
        return self.forward_with_aux(x)[0]

    def forward_with_aux(self, x):
        """``(y, aux)``: add ``aux * coef`` to a training objective."""
        b, t, d = x.shape
        xf = x.reshape(b * t, d)
        logits = F.matmul(xf, self.w_gate)
        dispatch, combine, aux = top_k_gating(logits, self.k,
                                              self.capacity(b * t))
        buf = _einsum("td,tec->ecd", xf, dispatch)         # [E, C, D]
        h = _einsum("ecd,edh->ech", buf, self.w1) + self.b1[:, None, :]
        h = A.gelu(h, approximate=True)
        out = _einsum("ech,ehd->ecd", h, self.w2) + self.b2[:, None, :]
        y = _einsum("ecd,tec->td", out, combine)
        return y.reshape(b, t, d), aux
