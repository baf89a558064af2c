"""Scan over layers with rematerialization (ref: ``paddle_tpu/nn/scan.py``).

:class:`ScanLayers` holds ``L`` homogeneous blocks as one prototype block
whose every parameter carries a leading layer axis, under the child name
``layer`` (``blocks.layer.fc1.weight`` ``[L, in, out]``): the JAX
package's scan-over-layers tree, so ``paddle_tpu_torch/bridge.py`` loads
such a tree as it is. The reference's ``lax.scan`` becomes a Python loop
that runs the prototype once a layer on that layer's slices through
``torch.func.functional_call``; each layer is a remat site:

  * ``"nothing"`` — no rematerialization (the reference flag's default;
    the port has no flags, so ``remat=None`` means this);
  * ``"full"`` — ``torch.utils.checkpoint`` (non-reentrant) per layer:
    only the layer's inputs are kept, the whole layer runs again in the
    backward;
  * ``"dots_saveable"`` — selective checkpointing that keeps the outputs
    of matrix products (``mm``, ``bmm``, ``addmm``, ``baddbmm``) and
    recomputes the rest, as ``jax.checkpoint_policies.dots_saveable``
    keeps only ``dot_general`` results. The port's kernels (flash
    attention, the fused MLP, layer norm) are no products, as a Pallas
    call is none: they run again, as the kernel, in the backward.

A layer that draws dropout masks draws them from the model's explicit
generators, which ``torch.utils.checkpoint`` does not rewind: the
generators named in ``gens`` are set back to their state at the layer's
first run for its recomputation, and restored after it, so the
recomputed masks are the ones the forward drew.
"""

import functools

import torch
from torch import nn
from torch.utils import checkpoint as ckpt

from paddle_tpu_torch.core.enforce import enforce

REMAT_POLICIES = ("nothing", "dots_saveable", "full")

#: the products whose outputs ``dots_saveable`` keeps
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
         torch.ops.aten.addmm.default, torch.ops.aten.baddbmm.default)


def resolve_remat(policy):
    """``policy``, validated; ``None`` is ``"nothing"``."""
    policy = "nothing" if policy is None else policy
    enforce(policy in REMAT_POLICIES,
            f"remat policy {policy!r} not in {REMAT_POLICIES}")
    return policy


def _dots_saveable(ctx, op, *args, **kwargs):
    if op in _DOTS:
        return ckpt.CheckpointPolicy.MUST_SAVE
    return ckpt.CheckpointPolicy.PREFER_RECOMPUTE


def _replaying(fn, gens):
    """``fn`` that, from its second call on, runs with ``gens`` set back
    to their states at the first call and restores them afterwards."""
    start = [g.get_state() for g in gens]
    calls = [0]

    def run(*args, **kwargs):
        calls[0] += 1
        if calls[0] == 1:
            return fn(*args, **kwargs)
        now = [g.get_state() for g in gens]
        for g, s in zip(gens, start):
            g.set_state(s)
        try:
            return fn(*args, **kwargs)
        finally:
            for g, s in zip(gens, now):
                g.set_state(s)
    return run


def apply_remat(fn, policy, gens=()):
    """``fn`` under the remat ``policy`` (ref: ``nn/scan.py:39``); the
    generators ``gens`` replay their draws in a recomputation."""
    policy = resolve_remat(policy)
    if policy == "nothing":
        return fn
    extra = {}
    if policy == "dots_saveable":
        extra["context_fn"] = functools.partial(
            ckpt.create_selective_checkpoint_contexts, _dots_saveable)

    def run(*args, **kwargs):
        return ckpt.checkpoint(_replaying(fn, gens), *args,
                               use_reentrant=False, **extra, **kwargs)
    return run


def _submodule(module, dotted):
    owner, _, leaf = dotted.rpartition(".")
    return (module.get_submodule(owner) if owner else module), leaf


class ScanLayers(nn.Module):
    """``len(layers)`` blocks stacked into one prototype (the first block,
    child ``layer``), run in order (ref: ``nn/scan.py:49``). The blocks
    must be parameter-only (no buffers), as the reference requires;
    they are built by the caller in order from its generator, so a scan
    model and an unrolled one drawn from the same seed hold the same
    weights. Keyword inputs (masks) pass to every layer."""

    def __init__(self, layers, remat=None, gens=()):
        super().__init__()
        layers = list(layers)
        self.num_layers = len(layers)
        self.remat = resolve_remat(remat)
        self.gens = tuple(gens)
        self.layer = layers[0]
        enforce(not list(self.layer.buffers()),
                "ScanLayers requires a stateless block (found buffers in "
                "the prototype layer)")
        self.names = [n for n, _ in self.layer.named_parameters()]
        per_layer = [dict(blk.named_parameters()) for blk in layers]
        for name in self.names:
            owner, leaf = _submodule(self.layer, name)
            stacked = torch.stack([p[name].detach() for p in per_layer])
            setattr(owner, leaf, nn.Parameter(
                stacked, requires_grad=per_layer[0][name].requires_grad))

    def _run_layer(self, x, *params, **kwargs):
        return torch.func.functional_call(
            self.layer, dict(zip(self.names, params)), (x,), kwargs)

    def forward(self, x, **kwargs):
        # read by attribute, so amp's functional_call copies are seen
        slices = [getattr(*_submodule(self.layer, n)).unbind(0)
                  for n in self.names]
        body = apply_remat(self._run_layer, self.remat, self.gens)
        for i in range(self.num_layers):
            x = body(x, *(s[i] for s in slices), **kwargs)
        return x
