"""Optimizers (ref: ``paddle_tpu/optimizer/optimizers.py``).

The reference is functional (``apply_gradients(params, grads, state)``
returns new params and state); the port is a ``torch.optim.Optimizer``
that updates the parameters and its per-parameter slots in place. Each
optimizer's update rule is the reference's, in the reference's dtypes,
and the state keeps the reference's names: one ``step`` count (an int32
0-d tensor on the parameters' device, :attr:`Optimizer.step_count` on the
host) and per-parameter slots (``moment1``/``moment2`` for Adam,
``velocity`` for Momentum ...), so ``paddle_tpu_torch/bridge.py`` carries
the state across in both directions and a checkpoint keys it by
parameter name.

A step runs the reference's order: clip the gradients, add the
regularizer's term, then update each parameter. The learning rate is a
schedule of the step count (``optimizer/lr_scheduler.py``), evaluated on
the device, so no step reads the host. A gated step (``gate=``, the
training guardian's containment) computes every new parameter and slot
first, then commits them only where ``isfinite(loss) & isfinite(global
update norm)`` holds on the device: a refused step leaves every
parameter, slot, floating buffer of the model (``minimize_gated`` holds
a copy of each) and the step count bit-identical, and still reads
nothing on the host. ``check_nan_inf`` is the reference's eager mode: it
raises ``EnforceError`` naming the non-finite gradients before anything
changes.

Parameters are given as tensors or as ``(name, tensor)`` pairs
(``model.named_parameters()``); the decay masks of :class:`AdamW` and
:class:`Lamb` are predicates of the name and need the pairs.
"""

import dataclasses

import torch

from paddle_tpu_torch.core.enforce import EnforceError, check_numerics
from paddle_tpu_torch.optimizer.lr_scheduler import make_schedule

F32 = torch.float32


def _moment_slots(p, state_dtype):
    """Adam-family moment slots (ref: ``optimizers.py:25``). moment1
    stores in ``state_dtype`` (or the param dtype); moment2 is pinned to
    f32 whenever ``state_dtype`` is narrower than 32 bits, since
    beta2 = 0.999's 1e-3 relative decay step is below bf16's half-ulp."""
    m1_dt = state_dtype or p.dtype
    if state_dtype is not None and torch.finfo(state_dtype).bits < 32:
        m2_dt = F32
    else:
        m2_dt = state_dtype or p.dtype
    return {"moment1": torch.zeros_like(p, dtype=m1_dt),
            "moment2": torch.zeros_like(p, dtype=m2_dt)}


def _update_sq_norm(news, olds, device):
    """``sum((new - old)^2)`` over every floating tensor, in f32: each
    difference in its tensor's dtype, as the reference takes it, its
    norm by the multi-tensor kernels (a few launches per dtype, not
    several per tensor), and the squares summed in f32."""
    groups = {}
    for n, o in zip(news, olds):
        if n.is_floating_point():
            groups.setdefault(n.dtype, ([], []))
            groups[n.dtype][0].append(n)
            groups[n.dtype][1].append(o)
    total = torch.zeros((), dtype=F32, device=device)
    for ns, os_ in groups.values():
        norms = torch.stack(torch._foreach_norm(torch._foreach_sub(ns, os_)))
        total = total + torch.sum(torch.square(norms.to(F32)))
    return total


@dataclasses.dataclass
class Gate:
    """What a gated step checks before it commits: the loss is always
    checked; ``check_update_norm`` adds the global norm of the update
    (every new parameter, slot and held buffer minus its old value, in
    f32). ``held`` are ``(buffer, value before the step)`` pairs that the
    commit keeps or puts back with the parameters: the model's floating
    buffers, which the forward wrote in place (batch norm's running
    statistics), as the reference gates every leaf of the new state."""

    check_update_norm: bool = True
    held: tuple = ()


def _split_named(params):
    """``(params, {param: name})`` from tensors or ``(name, tensor)``
    pairs."""
    params = list(params)
    if params and isinstance(params[0], tuple):
        return [p for _, p in params], {p: n for n, p in params}
    return params, {}


class Minimizer:
    """``minimize`` and ``minimize_gated`` over :meth:`_minimize`, shared
    by the optimizers and the wrappers around them."""

    def minimize(self, model, loss_fn, *args, **kwargs):
        """``loss = loss_fn(model, *args, **kwargs)``, its backward and one
        update (ref: ``minimize`` :160). Gradients are cleared before the
        backward and kept after the update. Returns the loss, detached."""
        return self._minimize(model, loss_fn, args, kwargs)[0]

    def minimize_gated(self, gate, model, loss_fn, *args, **kwargs):
        """:meth:`minimize` with the commit gated by ``gate``
        (:class:`Gate`). The model's floating buffers are copied first and
        held by the gate, so a refused step leaves them bit-identical too.
        Returns ``(loss, applied)``, ``applied`` a 0-d bool tensor on the
        device that nothing here reads."""
        with torch.no_grad():
            held = tuple((b, b.clone()) for b in model.buffers()
                         if b.is_floating_point())
        return self._minimize(model, loss_fn, args, kwargs,
                              dataclasses.replace(gate, held=held))

    def _minimize(self, model, loss_fn, args, kwargs, gate=None):
        self.zero_grad(set_to_none=True)
        loss = loss_fn(model, *args, **kwargs)
        loss.backward()
        loss = loss.detach()
        return loss, self.apply_gradients(loss, gate)


class Optimizer(Minimizer, torch.optim.Optimizer):
    """Base (ref: ``optimizers.py:40``). Subclasses define :meth:`slots`
    and :meth:`_update_leaf`; :meth:`step` applies the update to every
    parameter with a gradient and counts the step."""

    def __init__(self, params, learning_rate=0.01, regularization=None,
                 grad_clip=None, check_nan_inf=False):
        params, self.param_names = _split_named(params)
        self.lr = make_schedule(learning_rate)
        self.regularization = regularization
        self.grad_clip = grad_clip
        self.check_nan_inf = bool(check_nan_inf)
        super().__init__(params, {})
        self._step = torch.zeros((), dtype=torch.int32,
                                 device=self.param_groups[0]["params"][0]
                                 .device)

    @property
    def step_count(self):
        """The step count on the host (reads the device)."""
        return int(self._step)

    def params(self):
        return [p for group in self.param_groups for p in group["params"]]

    def name_of(self, p):
        name = self.param_names.get(p)
        if name is None:
            raise EnforceError(
                f"{type(self).__name__}: a decay mask keys parameters by "
                "name; construct the optimizer with model.named_parameters()")
        return name

    # -- subclass API --
    def slots(self, p):
        """Per-parameter slot init: dict name -> tensor."""
        return {}

    def _begin(self, step):
        """Per-step quantities that every leaf shares (bias corrections),
        computed once from the device step count."""

    def _update_leaf(self, g, p, slots, lr, step):
        raise NotImplementedError

    # -- the step --
    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        self.apply_gradients()
        return loss

    @torch.no_grad()
    def apply_gradients(self, loss=None, gate=None):
        """One update of every parameter that has a gradient (ref:
        ``apply_gradients`` :76): clip, regularize, per-parameter update.
        Ungated (``gate`` None) each parameter commits as it is computed
        and None is returned; gated, see the module docstring, and the
        0-d bool ``applied`` is returned."""
        params = [p for p in self.params() if p.grad is not None]
        grads = [p.grad for p in params]
        if self.check_nan_inf:
            check_numerics({self.param_names.get(p, i): g for i, (p, g)
                            in enumerate(zip(params, grads))}, "gradients")
        if self.grad_clip is not None:
            grads = self.grad_clip(grads)
        if self.regularization is not None:
            grads = self.regularization(grads, params)
        step = self._step
        lr = self.lr(step)
        self._begin(step)
        pending = []
        for g, p in zip(grads, params):
            state = self.state[p]
            if not state:
                state.update(self.slots(p))
            new_p, new_slots = self._update_leaf(g, p, state, lr, step)
            if gate is None:
                p.copy_(new_p)
                state.update(new_slots)
            else:
                pending.append((p, new_p, state, new_slots))
        if gate is None:
            self._step += 1
            return None
        return self._commit_gated(pending, loss, gate)

    def _commit_gated(self, pending, loss, gate):
        olds = [t for p, _, s, ns in pending for t in [p] + [s[k] for k in ns]]
        news = [t for _, n, _, ns in pending for t in [n] + list(ns.values())]
        ok = torch.isfinite(loss)
        if gate.check_update_norm:
            ok = ok & torch.isfinite(_update_sq_norm(
                news + [b for b, _ in gate.held],
                olds + [old for _, old in gate.held], self._step.device))
        for n, o in zip(news, olds):
            torch.where(ok, n, o, out=o)
        for b, old in gate.held:
            torch.where(ok, b, old, out=b)
        self._step += ok.to(torch.int32)
        return ok

    # -- state for the bridge and checkpoints --
    def state_tree(self, named):
        """``{"step", "slots": {name: {slot: tensor}}}`` over ``named``
        (name -> parameter); a parameter not stepped yet has the zero
        slots it would start with."""
        return {"step": self._step.clone(),
                "slots": {name: dict(self.state.get(p) or self.slots(p))
                          for name, p in named.items()}}

    def load_state_tree(self, named, tree):
        """Set the step count and slots from :meth:`state_tree`'s form (any
        float leaves), in the dtypes :meth:`slots` chooses, on each
        parameter's device."""
        slots = tree["slots"]
        missing = sorted(set(named) - set(slots))
        extra = sorted(set(slots) - set(named))
        if missing or extra:
            raise KeyError(f"slot trees differ: missing {missing[:5]}, extra "
                           f"{extra[:5]}")
        for name, p in named.items():
            template = self.slots(p)
            if sorted(template) != sorted(slots[name]):
                raise KeyError(f"{name}: slots {sorted(slots[name])}, the "
                               f"optimizer keeps {sorted(template)}")
            st = self.state[p]
            st.clear()
            for slot, like in template.items():
                val = torch.as_tensor(slots[name][slot])
                if tuple(val.shape) != tuple(p.shape):
                    raise ValueError(f"{name}.{slot}: shape "
                                     f"{tuple(val.shape)} vs "
                                     f"{tuple(p.shape)}")
                st[slot] = val.to(p.device, like.dtype).clone()
        self._step.fill_(int(torch.as_tensor(tree["step"])))


class SGD(Optimizer):
    """ref: operators/optimizers/sgd_op.cc"""

    def _update_leaf(self, g, p, s, lr, step):
        return p - lr * g.to(p.dtype), s


class Momentum(Optimizer):
    """ref: ``optimizers.py:180`` (velocity = mu*v + g; p -= lr * (g +
    mu*v) if nesterov else lr*v). ``state_dtype`` stores the velocity;
    the update runs in the wider of the param and state dtypes."""

    def __init__(self, params, learning_rate=0.01, momentum=0.9,
                 use_nesterov=False, state_dtype=None, **kw):
        super().__init__(params, learning_rate, **kw)
        self.mu = momentum
        self.nesterov = use_nesterov
        self.state_dtype = state_dtype

    def slots(self, p):
        return {"velocity": torch.zeros_like(
            p, dtype=self.state_dtype or p.dtype)}

    def _update_leaf(self, g, p, s, lr, step):
        cd = torch.promote_types(p.dtype, s["velocity"].dtype)
        g = g.to(cd)
        v = self.mu * s["velocity"].to(cd) + g
        if self.nesterov:
            new_p = (p.to(cd) - lr * (g + self.mu * v)).to(p.dtype)
        else:
            new_p = (p.to(cd) - lr * v).to(p.dtype)
        return new_p, {"velocity": v.to(s["velocity"].dtype)}


class LarsMomentum(Optimizer):
    """LARS (ref: operators/optimizers/lars_momentum_op.cc): layer-wise
    adaptive rate = lr * coeff * ||p|| / (||g|| + lambda*||p||)."""

    def __init__(self, params, learning_rate=0.01, momentum=0.9,
                 lars_coeff=1e-3, lars_weight_decay=5e-4, epsilon=1e-9,
                 **kw):
        super().__init__(params, learning_rate, **kw)
        self.mu = momentum
        self.coeff = lars_coeff
        self.wd = lars_weight_decay
        self.eps = epsilon

    def slots(self, p):
        return {"velocity": torch.zeros_like(p)}

    def _update_leaf(self, g, p, s, lr, step):
        g = g.to(F32)
        pf = p.to(F32)
        pn = torch.sqrt(torch.sum(torch.square(pf)))
        gn = torch.sqrt(torch.sum(torch.square(g)))
        local = self.coeff * pn / (gn + self.wd * pn + self.eps)
        local = torch.where(pn > 0, local, 1.0)
        v = self.mu * s["velocity"] + lr * local * (g + self.wd * pf)
        return (pf - v).to(p.dtype), {"velocity": v}


class Adagrad(Optimizer):
    """ref: operators/optimizers/adagrad_op.cc"""

    def __init__(self, params, learning_rate=0.01, epsilon=1e-6,
                 initial_accumulator_value=0.0, **kw):
        super().__init__(params, learning_rate, **kw)
        self.eps = epsilon
        self.init_acc = initial_accumulator_value

    def slots(self, p):
        return {"moment": torch.full_like(p, self.init_acc)}

    def _update_leaf(self, g, p, s, lr, step):
        g = g.to(p.dtype)
        m = s["moment"] + torch.square(g)
        return p - lr * g / (torch.sqrt(m) + self.eps), {"moment": m}


class DecayedAdagrad(Optimizer):
    """ref: operators/optimizers/decayed_adagrad_op.cc"""

    def __init__(self, params, learning_rate=0.01, decay=0.95,
                 epsilon=1e-6, **kw):
        super().__init__(params, learning_rate, **kw)
        self.decay, self.eps = decay, epsilon

    def slots(self, p):
        return {"moment": torch.zeros_like(p)}

    def _update_leaf(self, g, p, s, lr, step):
        g = g.to(p.dtype)
        m = self.decay * s["moment"] + (1 - self.decay) * torch.square(g)
        return p - lr * g / (torch.sqrt(m) + self.eps), {"moment": m}


class Adadelta(Optimizer):
    """ref: operators/optimizers/adadelta_op.cc"""

    def __init__(self, params, learning_rate=1.0, epsilon=1e-6, rho=0.95,
                 **kw):
        super().__init__(params, learning_rate, **kw)
        self.eps, self.rho = epsilon, rho

    def slots(self, p):
        return {"avg_squared_grad": torch.zeros_like(p),
                "avg_squared_update": torch.zeros_like(p)}

    def _update_leaf(self, g, p, s, lr, step):
        g = g.to(p.dtype)
        asg = (self.rho * s["avg_squared_grad"]
               + (1 - self.rho) * torch.square(g))
        upd = g * torch.sqrt(s["avg_squared_update"] + self.eps) / \
            torch.sqrt(asg + self.eps)
        asu = (self.rho * s["avg_squared_update"]
               + (1 - self.rho) * torch.square(upd))
        return p - lr * upd, {"avg_squared_grad": asg,
                              "avg_squared_update": asu}


class RMSProp(Optimizer):
    """ref: operators/optimizers/rmsprop_op.cc (centered + momentum)."""

    def __init__(self, params, learning_rate=0.01, rho=0.95, epsilon=1e-6,
                 momentum=0.0, centered=False, **kw):
        super().__init__(params, learning_rate, **kw)
        self.rho, self.eps, self.mu = rho, epsilon, momentum
        self.centered = centered

    def slots(self, p):
        s = {"mean_square": torch.zeros_like(p),
             "moment": torch.zeros_like(p)}
        if self.centered:
            s["mean_grad"] = torch.zeros_like(p)
        return s

    def _update_leaf(self, g, p, s, lr, step):
        g = g.to(p.dtype)
        ms = self.rho * s["mean_square"] + (1 - self.rho) * torch.square(g)
        out = {"mean_square": ms}
        if self.centered:
            mg = self.rho * s["mean_grad"] + (1 - self.rho) * g
            denom = torch.sqrt(ms - torch.square(mg) + self.eps)
            out["mean_grad"] = mg
        else:
            denom = torch.sqrt(ms + self.eps)
        mom = self.mu * s["moment"] + lr * g / denom
        out["moment"] = mom
        return p - mom, out


def _bias_corrections(step, *betas):
    """``1 - beta ** (step + 1)`` in f32 for each beta."""
    t = (step + 1).to(F32)
    return [1 - torch.pow(b, t) for b in betas]


class Adam(Optimizer):
    """ref: ``optimizers.py:325`` — bias-corrected Adam, the update in f32,
    slots stored in the dtypes :func:`_moment_slots` chose.
    ``state_dtype`` narrows moment1 only. ``lazy_mode`` is the
    reference's documented no-op."""

    def __init__(self, params, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, lazy_mode=False, state_dtype=None, **kw):
        super().__init__(params, learning_rate, **kw)
        self.b1, self.b2, self.eps = beta1, beta2, epsilon
        self.state_dtype = state_dtype

    def slots(self, p):
        return _moment_slots(p, self.state_dtype)

    def _begin(self, step):
        self._bc = _bias_corrections(step, self.b1, self.b2)

    def _moments(self, g, s):
        g = g.to(F32)
        m = self.b1 * s["moment1"].to(F32) + (1 - self.b1) * g
        v = self.b2 * s["moment2"].to(F32) + (1 - self.b2) * torch.square(g)
        return m, v, m / self._bc[0], v / self._bc[1]

    def _update_leaf(self, g, p, s, lr, step):
        m, v, mhat, vhat = self._moments(g, s)
        new_p = p.to(F32) - lr * mhat / (torch.sqrt(vhat) + self.eps)
        return new_p.to(p.dtype), {
            "moment1": m.to(s["moment1"].dtype),
            "moment2": v.to(s["moment2"].dtype)}


class AdamW(Adam):
    """Decoupled weight decay (ref: ``optimizers.py:369``).
    ``decay_mask_fn(name) -> bool`` (True = decay this parameter) is the
    reference's ``decay_mask_fn(params)`` as a predicate of the
    parameter's name."""

    def __init__(self, params, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, weight_decay=0.01, decay_mask_fn=None, **kw):
        super().__init__(params, learning_rate, beta1, beta2, epsilon, **kw)
        self.wd = weight_decay
        self.decay_mask_fn = decay_mask_fn

    def _update_leaf(self, g, p, s, lr, step):
        new_p, slots = super()._update_leaf(g, p, s, lr, step)
        decay = self.wd
        if self.decay_mask_fn is not None and not self.decay_mask_fn(
                self.name_of(p)):
            decay = 0.0
        if decay:
            new_p = new_p - lr * decay * p
        return new_p, slots


class Adamax(Optimizer):
    """ref: operators/optimizers/adamax_op.h"""

    def __init__(self, params, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, **kw):
        super().__init__(params, learning_rate, **kw)
        self.b1, self.b2, self.eps = beta1, beta2, epsilon

    def slots(self, p):
        return {"moment": torch.zeros_like(p),
                "inf_norm": torch.zeros_like(p)}

    def _begin(self, step):
        self._bc1, = _bias_corrections(step, self.b1)

    def _update_leaf(self, g, p, s, lr, step):
        g = g.to(p.dtype)
        m = self.b1 * s["moment"] + (1 - self.b1) * g
        u = torch.maximum(self.b2 * s["inf_norm"], torch.abs(g))
        new_p = p - (lr / self._bc1) * m / (u + self.eps)
        return new_p, {"moment": m, "inf_norm": u}


class Ftrl(Optimizer):
    """ref: operators/optimizers/ftrl_op.h"""

    def __init__(self, params, learning_rate=0.01, l1=0.0, l2=0.0,
                 lr_power=-0.5, **kw):
        super().__init__(params, learning_rate, **kw)
        self.l1, self.l2, self.lr_power = l1, l2, lr_power

    def slots(self, p):
        return {"squared": torch.zeros_like(p),
                "linear": torch.zeros_like(p)}

    def _update_leaf(self, g, p, s, lr, step):
        g = g.to(p.dtype)
        new_sq = s["squared"] + torch.square(g)
        lp = -self.lr_power
        sigma = (torch.pow(new_sq, lp) - torch.pow(s["squared"], lp)) / lr
        lin = s["linear"] + g - sigma * p
        quad = torch.pow(new_sq, lp) / lr + 2 * self.l2
        pre = -lin + torch.sign(lin) * self.l1
        new_p = torch.where(torch.abs(lin) > self.l1, pre / quad, 0.0)
        return new_p, {"squared": new_sq, "linear": lin}


class Lamb(Optimizer):
    """ref: ``optimizers.py:448`` — layer-wise adaptation for large batch
    (BERT-scale), with Adam's ``state_dtype`` rule.
    ``exclude_from_weight_decay_fn(name) -> bool`` (True = no decay for
    this parameter; the BERT recipe excludes layer-norm scales and
    biases) is the reference's predicate of the params tree as a
    predicate of the parameter's name."""

    def __init__(self, params, learning_rate=0.001, lamb_weight_decay=0.01,
                 beta1=0.9, beta2=0.999, epsilon=1e-6,
                 exclude_from_weight_decay_fn=None, state_dtype=None, **kw):
        super().__init__(params, learning_rate, **kw)
        self.wd = lamb_weight_decay
        self.b1, self.b2, self.eps = beta1, beta2, epsilon
        self.exclude_fn = exclude_from_weight_decay_fn
        self.state_dtype = state_dtype

    def slots(self, p):
        return _moment_slots(p, self.state_dtype)

    _begin = Adam._begin
    _moments = Adam._moments

    def _update_leaf(self, g, p, s, lr, step):
        wd = self.wd
        if self.exclude_fn is not None and self.exclude_fn(self.name_of(p)):
            wd = 0.0
        pf = p.to(F32)
        m, v, mhat, vhat = self._moments(g, s)
        r = mhat / (torch.sqrt(vhat) + self.eps) + wd * pf
        pn = torch.sqrt(torch.sum(torch.square(pf)))
        rn = torch.sqrt(torch.sum(torch.square(r)))
        trust = torch.where((pn > 0) & (rn > 0), pn / rn, 1.0)
        return (pf - lr * trust * r).to(p.dtype), {
            "moment1": m.to(s["moment1"].dtype),
            "moment2": v.to(s["moment2"].dtype)}


class Dpsgd(Optimizer):
    """Differentially-private SGD (ref: operators/optimizers/dpsgd_op.cc):
    clip per update + Gaussian noise. The noise comes from
    :attr:`generator`, a ``torch.Generator`` on the parameters' device
    seeded with ``seed``, drawn parameter by parameter in order (the
    reference folds the step and the leaf index into a threefry key,
    which torch cannot reproduce); its state rides checkpoints
    (``core/random.py``). The reference's noise follows the step count,
    which a refused gated step leaves as it was; here the draws of a
    refused step are undone, so the generator, too, is as it was."""

    def __init__(self, params, learning_rate=0.01, clip=10.0,
                 batch_size=16.0, sigma=1.0, seed=0, **kw):
        super().__init__(params, learning_rate, **kw)
        self.clip_v, self.batch_size, self.sigma = clip, batch_size, sigma
        self._generator = torch.Generator(
            device=self._step.device).manual_seed(seed)
        self._undo = None

    @property
    def generator(self):
        """The noise generator. The draws of a refused gated step are
        undone the first time the generator is used or read after that
        step: its ``applied`` flag is read then, a step later, as the
        guardian reads a step's loss, so the gated step itself still reads
        nothing on the host."""
        if self._undo is not None:
            state, applied = self._undo
            self._undo = None
            if not bool(applied):
                self._generator.set_state(state)
        return self._generator

    @torch.no_grad()
    def apply_gradients(self, loss=None, gate=None):
        before = self.generator.get_state() if gate is not None else None
        applied = super().apply_gradients(loss, gate)
        if gate is not None:
            self._undo = (before, applied)
        return applied

    def _update_leaf(self, g, p, s, lr, step):
        g = g.to(p.dtype)
        gn = torch.sqrt(torch.sum(torch.square(g)))
        g = g * torch.clamp(torch.div(self.clip_v, torch.clamp(gn, min=1e-12)),
                            max=1.0)
        noise = self.sigma * self.clip_v / self.batch_size * torch.randn(
            g.shape, generator=self.generator, dtype=g.dtype, device=g.device)
        return p - lr * (g + noise), s
