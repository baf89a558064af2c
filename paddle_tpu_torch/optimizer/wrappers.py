"""Meta-optimizers and averaging wrappers (ref:
``paddle_tpu/optimizer/wrappers.py``).

:class:`Lookahead` and :class:`RecomputeOptimizer` wrap an optimizer (or
an ``amp.decorate`` wrapper) and keep its ``minimize`` /
``minimize_gated`` / ``apply_gradients`` surface; the averages
(:class:`ExponentialMovingAverage`, :class:`ModelAverage`) follow the
parameters from outside the step, as the reference's do. Every state is
keyed by parameter name (``state_tree(named)``) for the bridge and
checkpoints.
"""

import torch
from torch.utils.checkpoint import checkpoint

from paddle_tpu_torch.core import random as _random
from paddle_tpu_torch.core.enforce import enforce_le
from paddle_tpu_torch.optimizer.optimizers import F32, Minimizer, Momentum


def _named(params):
    params = list(params)
    if params and isinstance(params[0], tuple):
        return dict(params)
    return {str(i): p for i, p in enumerate(params)}


def _load_tensors(dst, src):
    """Copy each of ``src``'s tensors into the same-named one of
    ``dst``."""
    if sorted(dst) != sorted(src):
        raise KeyError(f"trees differ: {sorted(set(dst) ^ set(src))[:5]}")
    for k, t in dst.items():
        t.copy_(torch.as_tensor(src[k]).to(t.device, t.dtype))


class ExponentialMovingAverage:
    """ref: ``wrappers.py:14`` — ``shadow = d*shadow + (1-d)*param`` with
    ``d = min(decay, (1 + step) / (10 + step))``. ``params`` are tensors
    or ``(name, tensor)`` pairs; call :meth:`update` after each step."""

    def __init__(self, params, decay=0.999):
        self.decay = decay
        self.params = _named(params)
        self.shadow = {k: p.detach().clone() for k, p in self.params.items()}
        self.step = torch.zeros((), dtype=torch.int32,
                                device=next(iter(self.params.values()))
                                .device)

    @torch.no_grad()
    def update(self):
        self.step += 1
        s = self.step.to(F32)
        d = torch.clamp(torch.div(1.0 + s, 10.0 + s), max=self.decay)
        for k, p in self.params.items():
            self.shadow[k].copy_(d * self.shadow[k] + (1 - d) * p)

    def apply(self):
        """The averaged parameters, by name (ref: EMA.apply)."""
        return self.shadow

    def state_tree(self, named=None):
        return {"shadow": dict(self.shadow), "step": self.step.clone()}

    def load_state_tree(self, named, tree):
        _load_tensors(self.shadow, tree["shadow"])
        self.step.fill_(int(torch.as_tensor(tree["step"])))


class ModelAverage:
    """ref: ``wrappers.py:37`` + operators/average_accumulates_op.h — the
    reference's window policy: per update ``sum_1 += p``; every 16384
    updates fold ``sum_1`` into ``sum_2``; restart the window when
    ``num_accumulates >= min_average_window`` and ``>= min(max_window,
    num_updates * rate)``; :meth:`apply` averages over both windows."""

    _MAX_NUM_ACCUMULATES = 16384

    def __init__(self, params, average_window_rate=0.15,
                 min_average_window=10000, max_average_window=10000):
        enforce_le(min_average_window, max_average_window,
                   "min_average_window shouldn't be larger than "
                   "max_average_window")
        self.rate = average_window_rate
        self.min_window = min_average_window
        self.max_window = max_average_window
        self.params = _named(params)
        self.sums = {n: {k: torch.zeros_like(p)
                         for k, p in self.params.items()}
                     for n in ("sum_1", "sum_2", "sum_3")}
        dev = next(iter(self.params.values())).device
        self.counts = {n: torch.zeros((), dtype=torch.int32, device=dev)
                       for n in ("num_updates", "num_accumulates",
                                 "old_num_accumulates")}

    @torch.no_grad()
    def update(self):
        c = self.counts
        num_updates = c["num_updates"] + 1
        num_acc = c["num_accumulates"] + 1
        fold = (num_updates % self._MAX_NUM_ACCUMULATES) == 0
        window = torch.clamp(num_updates.to(F32) * self.rate,
                             max=float(self.max_window))
        restart = (num_acc >= self.min_window) & (num_acc.to(F32) >= window)
        s1, s2, s3 = (self.sums[n] for n in ("sum_1", "sum_2", "sum_3"))
        for k, p in self.params.items():
            a = s1[k] + p
            b = torch.where(fold, s2[k] + a, s2[k])
            a = torch.where(fold, torch.zeros_like(a), a)
            s3[k].copy_(torch.where(restart, a + b, s3[k]))
            s1[k].copy_(torch.where(restart, torch.zeros_like(a), a))
            s2[k].copy_(torch.where(restart, torch.zeros_like(b), b))
        c["old_num_accumulates"].copy_(torch.where(
            restart, num_acc, c["old_num_accumulates"]))
        c["num_accumulates"].copy_(torch.where(restart, 0, num_acc))
        c["num_updates"].copy_(num_updates)

    def apply(self):
        c = self.counts
        denom = torch.clamp((c["num_accumulates"]
                             + c["old_num_accumulates"]).to(F32), min=1.0)
        return {k: (self.sums["sum_1"][k] + self.sums["sum_2"][k]
                    + self.sums["sum_3"][k]) / denom for k in self.params}

    def state_tree(self, named=None):
        return {**{n: dict(s) for n, s in self.sums.items()},
                **{n: t.clone() for n, t in self.counts.items()}}

    def load_state_tree(self, named, tree):
        for n, s in self.sums.items():
            _load_tensors(s, tree[n])
        for n, t in self.counts.items():
            t.fill_(int(torch.as_tensor(tree[n])))


class _Wrapper(Minimizer):
    """Delegates the optimizer surface to :attr:`inner`."""

    def __init__(self, inner):
        self.inner = inner

    def zero_grad(self, set_to_none=True):
        self.inner.zero_grad(set_to_none=set_to_none)

    def params(self):
        return self.inner.params()

    def apply_gradients(self, loss=None, gate=None):
        return self.inner.apply_gradients(loss, gate)


class Lookahead(_Wrapper):
    """ref: ``wrappers.py:104`` LookaheadOptimizer — every ``k`` applied
    steps the slow weights move ``alpha`` of the way to the fast ones,
    and the fast ones take the slow ones' values. Under a gate the sync
    counts only applied steps, as the reference's gated state would."""

    def __init__(self, inner, alpha=0.5, k=5):
        super().__init__(inner)
        self.alpha, self.k = alpha, k
        params = inner.params()
        self.slow = {p: p.detach().clone() for p in params}
        self._step = torch.zeros((), dtype=torch.int32,
                                 device=params[0].device)

    @torch.no_grad()
    def apply_gradients(self, loss=None, gate=None):
        applied = self.inner.apply_gradients(loss, gate)
        step = self._step + 1
        sync = (step % self.k) == 0
        if applied is not None:
            sync = sync & applied
            step = torch.where(applied, step, self._step)
        self._step.copy_(step)
        for p, s in self.slow.items():
            s.copy_(torch.where(sync, s + self.alpha * (p - s), s))
            p.copy_(torch.where(sync, s, p))
        return applied

    def state_tree(self, named):
        return {"inner": self.inner.state_tree(named),
                "slow": {n: self.slow[p] for n, p in named.items()},
                "step": self._step.clone()}

    def load_state_tree(self, named, tree):
        self.inner.load_state_tree(named, tree["inner"])
        _load_tensors({n: self.slow[p] for n, p in named.items()},
                      tree["slow"])
        self._step.fill_(int(torch.as_tensor(tree["step"])))


class RecomputeOptimizer(_Wrapper):
    """Activation recomputation (ref: ``wrappers.py:131``): the loss runs
    under ``torch.utils.checkpoint(..., use_reentrant=False)``, so the
    backward re-runs the forward instead of keeping its activations.

    Two things the reference's ``jax.checkpoint`` gets for free are made
    explicit. The parameters enter the checkpointed function as inputs
    (under ``amp.decorate`` they are the compute-dtype copies, which the
    recompute must see again, not the masters). And the model's explicit
    generators (``core/random.py``: ``dropout_gen``), which
    ``preserve_rng_state`` does not cover, are set back to their state
    before the forward when the recompute starts, so it draws the same
    dropout masks; after the backward they stand where the plain step
    leaves them."""

    def __init__(self, inner, policy=None):
        if policy is not None:
            raise NotImplementedError(
                "RecomputeOptimizer(policy=...): checkpoint policies are not "
                "ported")
        super().__init__(inner)

    def state_tree(self, named):
        return self.inner.state_tree(named)

    def load_state_tree(self, named, tree):
        self.inner.load_state_tree(named, tree)

    def wrap(self, fn):
        from paddle_tpu_torch.amp import _Bound

        def recomputed(model, *args, **kwargs):
            names, tensors = zip(*model.named_parameters())
            gens = _random.model_generators(model)
            before = {k: g.get_state() for k, g in gens.items()}
            calls = [0]

            def run(*flat):
                if calls[0]:
                    for k, g in gens.items():
                        g.set_state(before[k])
                calls[0] += 1
                params = {"model." + n: t
                          for n, t in zip(names, flat[:len(names)])}
                return torch.func.functional_call(
                    _Bound(model, fn), params, flat[len(names):], kwargs)

            return checkpoint(run, *tensors, *args, use_reentrant=False)
        return recomputed

    def _minimize(self, model, loss_fn, args, kwargs, gate=None):
        # through inner._minimize, so that RecomputeOptimizer(decorate(..))
        # checkpoints the loss the amp path differentiates
        return self.inner._minimize(model, self.wrap(loss_fn), args, kwargs,
                                    gate)


def topk_sparsify(g, sparsity):
    """Keep the top-(1-sparsity) fraction of |g|; returns (sparse_g,
    residual), ``sparse_g + residual == g`` (the port's copy of
    ``paddle_tpu/parallel/dgc.py topk_sparsify``)."""
    flat = g.reshape(-1)
    k = max(1, int(flat.shape[0] * (1.0 - sparsity)))
    _, idx = torch.topk(torch.abs(flat), k)
    mask = torch.zeros_like(flat, dtype=torch.bool)
    mask[idx] = True
    sparse = torch.where(mask, flat, 0).reshape(g.shape)
    return sparse, g - sparse


class DGCMomentum(Momentum):
    """Deep-gradient-compression momentum (ref: ``wrappers.py:172``):
    top-k sparsify the gradient plus the carried residual, from
    ``rampup_begin_step`` on; the single-process semantics (the
    compressed all-reduce is not ported)."""

    def __init__(self, params, learning_rate=0.01, momentum=0.9,
                 rampup_begin_step=0, sparsity=0.999, **kw):
        super().__init__(params, learning_rate, momentum, **kw)
        self.begin = rampup_begin_step
        self.sparsity = sparsity

    def slots(self, p):
        s = super().slots(p)
        s["residual"] = torch.zeros_like(p)
        return s

    def _update_leaf(self, g, p, s, lr, step):
        g = g.to(p.dtype)
        acc = s["residual"] + g
        use_dgc = step >= self.begin
        sparse_g, residual = topk_sparsify(acc, self.sparsity)
        g_eff = torch.where(use_dgc, sparse_g, g)
        new_res = torch.where(use_dgc, residual, s["residual"])
        new_p, ms = super()._update_leaf(
            g_eff, p, {"velocity": s["velocity"]}, lr, step)
        return new_p, {"velocity": ms["velocity"], "residual": new_res}
