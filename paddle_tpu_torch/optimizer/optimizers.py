"""Optimizers (ref: ``paddle_tpu/optimizer/optimizers.py``).

The reference is functional (``apply_gradients(params, grads, state)``
returns new params and state); the port is a ``torch.optim.Optimizer``
that updates the parameters and its per-parameter slots in place. The
update rule of each optimizer is the reference's, in f32, and the state
keeps the reference's names: one ``step`` count for the optimizer
(:attr:`Optimizer.step_count`) and per-parameter slots
(``moment1``/``moment2`` for Adam), so ``paddle_tpu_torch/bridge.py`` can
carry the state across in both directions.

Not ported yet: learning-rate schedules (the rate is a constant float),
gradient clipping, regularizers, the ``check_nan_inf`` guard, and every
optimizer but Adam.
"""

import numpy as np
import torch


def _moment_slots(p, state_dtype):
    """Adam-family moment slots (ref: ``optimizers.py:25``). moment1
    stores in ``state_dtype`` (or the param dtype); moment2 is pinned to
    f32 whenever ``state_dtype`` is narrower than 32 bits, since
    beta2 = 0.999's 1e-3 relative decay step is below bf16's half-ulp."""
    m1_dt = state_dtype or p.dtype
    if state_dtype is not None and torch.finfo(state_dtype).bits < 32:
        m2_dt = torch.float32
    else:
        m2_dt = state_dtype or p.dtype
    return {"moment1": torch.zeros_like(p, dtype=m1_dt),
            "moment2": torch.zeros_like(p, dtype=m2_dt)}


class Optimizer(torch.optim.Optimizer):
    """Base (ref: ``optimizers.py:40``). Subclasses define :meth:`slots`
    and :meth:`_update_leaf`; :meth:`step` applies the update to every
    parameter with a gradient and counts the step."""

    def __init__(self, params, learning_rate=0.01):
        self.lr = float(learning_rate)
        self.step_count = 0
        super().__init__(params, {})

    def slots(self, p):
        """Per-parameter slot init: dict name -> tensor."""
        return {}

    def _update_leaf(self, g, p, slots, lr, step):
        raise NotImplementedError

    @torch.no_grad()
    def step(self, closure=None):
        """One update of every parameter that has a gradient (ref:
        ``apply_gradients`` :76)."""
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                state = self.state[p]
                if not state:
                    state.update(self.slots(p))
                new_p, new_slots = self._update_leaf(p.grad, p, state,
                                                     self.lr, self.step_count)
                p.copy_(new_p)
                state.update(new_slots)
        self.step_count += 1
        return loss

    def minimize(self, model, loss_fn, *args, **kwargs):
        """``loss = loss_fn(model, *args, **kwargs)``, its backward and one
        :meth:`step` (ref: ``minimize`` :160). Gradients are cleared
        before the backward and kept after the step. Returns the loss,
        detached."""
        self.zero_grad(set_to_none=True)
        loss = loss_fn(model, *args, **kwargs)
        loss.backward()
        self.step()
        return loss.detach()


class Adam(Optimizer):
    """ref: ``optimizers.py:325`` — bias-corrected Adam, the update in f32
    (bias correction by ``step + 1``), slots stored in the dtypes
    :func:`_moment_slots` chose. ``state_dtype`` narrows moment1 only."""

    def __init__(self, params, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, state_dtype=None):
        super().__init__(params, learning_rate)
        self.b1, self.b2, self.eps = beta1, beta2, epsilon
        self.state_dtype = state_dtype

    def slots(self, p):
        return _moment_slots(p, self.state_dtype)

    def _update_leaf(self, g, p, s, lr, step):
        g = g.float()
        # the bias corrections in f32, as the reference computes them
        t = np.float32(step + 1)
        bc1 = float(np.float32(1) - np.float32(self.b1) ** t)
        bc2 = float(np.float32(1) - np.float32(self.b2) ** t)
        m = self.b1 * s["moment1"].float() + (1 - self.b1) * g
        v = self.b2 * s["moment2"].float() + (1 - self.b2) * torch.square(g)
        mhat = m / bc1
        vhat = v / bc2
        new_p = p.float() - lr * mhat / (torch.sqrt(vhat) + self.eps)
        return new_p.to(p.dtype), {
            "moment1": m.to(s["moment1"].dtype),
            "moment2": v.to(s["moment2"].dtype)}
