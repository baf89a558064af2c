"""The port's schedules, clips, regularizers, optimizers and wrappers
against the JAX package's, on the CPU.

The model is a tiny GPT (``vocab 64, hidden 32, 2 layers, 2 heads``) at
B x T = 2 x 16, its weights made by the JAX package from a seed and
bridged into the port. Every optimizer takes one JAX step first (so the
carried slots are not zero), its state is bridged, and then both sides
take 3 steps with a warm-up-then-polynomial schedule,
``ClipByGlobalNorm(1.0)`` and ``L2Decay(1e-3)``.

Tolerances: schedules within 1e-6 relative (both compute in f32 from an
int32 step); clips and regularizers within 1e-6; the loss within 1e-5;
every slot within 1e-4 relative plus 1e-5 of its slot's largest value
(the bar of ``test_adam_three_steps_match_jax_from_bridged_state``);
parameters and Lookahead's slow weights within 1e-4 relative plus 1e-5,
well below one step's movement, and the loss after the last update
within 1e-5, which holds that update too. The attention key biases are
the exception: softmax over the keys is invariant to a shift shared by
every key, so their gradient is 0 in exact arithmetic and rounding
noise in practice, and an adaptive optimizer moves them by about lr in
the noise's sign. They do not change the loss; they are held within
2 * peak lr * steps. Dpsgd's noise cannot match threefry:
it is held at sigma = 0 against JAX and to its own determinism and
variance.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu.optimizer as J
import paddle_tpu_torch.optimizer as P
from paddle_tpu.core.flags import all_flags, set_flags

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
PARAM_TOL = dict(rtol=1e-4, atol=1e-5)
KW = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=2,
          intermediate_size=64, max_position=32, dropout=0.0)
B, T = 2, 16
STEPS = 3


def t(a):
    return torch.from_numpy(np.array(np.asarray(a)))


def n(x):
    return x.detach().float().numpy()


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _flat(tree):
    from paddle_tpu_torch import bridge
    return bridge.flatten(_np(tree))


def _pair(seed=0):
    from paddle_tpu.models.gpt import GPT, GPTConfig
    from paddle_tpu_torch import bridge
    from paddle_tpu_torch.models.gpt import GPT as PGPT
    from paddle_tpu_torch.models.gpt import GPTConfig as PConfig
    jm = GPT(GPTConfig(**KW))
    params = jm.init(jax.random.key(seed))["params"]
    pm = PGPT(PConfig(**KW), device="cpu", seed=seed + 7)
    bridge.load_params(pm, _np(params))
    return jm, params, pm


def _ids(seed):
    return np.random.RandomState(seed).randint(0, 64, (B, T)).astype(
        np.int32)


# --------------------------------------------------------------- schedules

def _schedules(lib):
    S = lib.lr_scheduler
    return {
        "constant": S.constant(0.1),
        "noam": S.noam_decay(64, 10, 2.0),
        "exponential": S.exponential_decay(0.1, 10, 0.5),
        "exponential_staircase": S.exponential_decay(0.1, 10, 0.5, True),
        "natural_exp": S.natural_exp_decay(0.1, 10, 0.3),
        "natural_exp_staircase": S.natural_exp_decay(0.1, 10, 0.3, True),
        "inverse_time": S.inverse_time_decay(0.1, 10, 0.5),
        "inverse_time_staircase": S.inverse_time_decay(0.1, 7, 0.5, True),
        "polynomial": S.polynomial_decay(0.1, 20, 1e-3, power=2.0),
        "polynomial_cycle": S.polynomial_decay(0.1, 20, 1e-3, cycle=True),
        "piecewise": S.piecewise_decay([10, 30], [0.1, 0.05, 0.01]),
        "cosine": S.cosine_decay(0.1, 8, 10),
        "cosine_steps": S.cosine_decay_steps(0.1, 40, 1e-3),
        "warmup_polynomial": S.linear_lr_warmup(
            S.polynomial_decay(1e-4, 16, 0.0), 4, 0.0, 1e-4),
        "warmup_float": S.linear_lr_warmup(0.05, 8, 0.01, 0.05),
        "make_schedule_float": S.make_schedule(0.02),
        "make_schedule_callable": S.make_schedule(S.noam_decay(32, 4)),
    }


@pytest.mark.parametrize("name", sorted(_schedules(P)))
def test_schedule_matches_jax(name):
    js, ps = _schedules(J)[name], _schedules(P)[name]
    steps = np.arange(65, dtype=np.int32)
    want = np.array([float(js(jnp.int32(s))) for s in steps], np.float32)
    got = torch.stack([ps(torch.tensor(int(s), dtype=torch.int32))
                       for s in steps])
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)


# ------------------------------------------------- clips and regularizers

def _grad_tree(seed):
    rs = np.random.RandomState(seed)
    return {"a": (rs.randn(8, 5) * 0.3).astype(np.float32),
            "b": (rs.randn(7) * 2.0).astype(np.float32),
            "c": (rs.randn(3, 4, 2) * 0.01).astype(np.float32)}


@pytest.mark.parametrize("which", ["value", "value_range", "norm",
                                   "global_norm", "global_norm_fn", "l2",
                                   "l1"])
def test_clip_and_regularizer_match_jax(which):
    grads, params = _grad_tree(1), _grad_tree(2)
    keys = sorted(grads)
    jg = {k: jnp.asarray(v) for k, v in grads.items()}
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    pg = [t(grads[k]) for k in keys]
    pp = [t(params[k]) for k in keys]
    if which == "global_norm_fn":
        np.testing.assert_allclose(float(P.global_norm(pg)),
                                   float(J.global_norm(jg)), rtol=1e-6)
        return
    if which in ("l2", "l1"):
        cls = "L2Decay" if which == "l2" else "L1Decay"
        want = getattr(J, cls)(1e-2)(jg, jp)
        got = getattr(P, cls)(1e-2)(pg, pp)
    else:
        make = {"value": lambda L: L.ClipByValue(0.2),
                "value_range": lambda L: L.ClipByValue(-0.1, 0.05),
                "norm": lambda L: L.ClipByNorm(0.5),
                "global_norm": lambda L: L.ClipByGlobalNorm(1.0)}[which]
        want, got = make(J)(jg), make(P)(pg)
    for k, g in zip(keys, got):
        np.testing.assert_allclose(n(g), np.asarray(want[k]), rtol=1e-6,
                                   atol=1e-7, err_msg=k)


# ---------------------------------------------- optimizers and wrappers

def _decays(name):
    """The BERT recipe's mask as a name predicate: no weight decay for
    layer-norm scales and biases."""
    return not name.endswith(("bias", "scale"))


def _jax_mask(pred):
    """The same predicate in the JAX package's form: a params tree ->
    bool tree."""
    def fn(params):
        return jax.tree_util.tree_map_with_path(
            lambda path, _: pred(".".join(
                str(getattr(k, "key", getattr(k, "idx", k)))
                for k in path)), params)
    return fn


OPTIMIZERS = {
    # name: (peak lr, kwargs of both sides, wrapper)
    "SGD": (0.05, {}, None),
    "Momentum": (0.05, dict(momentum=0.9), None),
    "Momentum_nesterov": (0.05, dict(momentum=0.9, use_nesterov=True),
                          None),
    "LarsMomentum": (0.5, dict(momentum=0.9), None),
    "Adagrad": (0.01, dict(initial_accumulator_value=0.1), None),
    "DecayedAdagrad": (0.01, {}, None),
    "Adadelta": (1.0, {}, None),
    "RMSProp": (0.01, {}, None),
    "RMSProp_centered": (0.01, dict(centered=True, momentum=0.9), None),
    "Adam": (1e-3, {}, None),
    "Adam_bf16_moment1": (1e-3, dict(state_dtype="bf16"), None),
    "AdamW": (1e-3, dict(weight_decay=0.05), None),
    "AdamW_masked": (1e-3, dict(weight_decay=0.05, decay_mask_fn=_decays),
                     None),
    "Adamax": (1e-3, {}, None),
    # l2 = 1 keeps FTRL's re-derived weights near the init: with a small
    # l2 they jump by ~lr |g| / sqrt(sum g^2) and the tiny model blows up
    "Ftrl": (0.05, dict(l1=1e-5, l2=1.0), None),
    "Lamb": (1e-3, {}, None),
    "Lamb_masked": (1e-3, dict(exclude_from_weight_decay_fn=lambda n:
                               not _decays(n)), None),
    "Dpsgd": (0.05, dict(sigma=0.0, clip=1.0), None),
    "DGCMomentum": (0.05, dict(momentum=0.9, sparsity=0.9,
                               rampup_begin_step=2), None),
    "Lookahead": (1e-3, {}, "Lookahead"),
    "RecomputeOptimizer": (1e-3, {}, "RecomputeOptimizer"),
}


def _make(lib, name, params):
    """The optimizer ``name`` of ``lib`` (the JAX package's optimizer
    module or the port's), with the schedule, the clip and the
    regularizer; ``params`` are the port's named parameters (None on the
    JAX side)."""
    lr, kw, wrapper = OPTIMIZERS[name]
    kw = dict(kw)
    cls = name.split("_")[0]
    if cls in ("Lookahead", "RecomputeOptimizer"):
        cls = "Adam"
    S = lib.lr_scheduler
    kw.update(regularization=lib.L2Decay(1e-3),
              grad_clip=lib.ClipByGlobalNorm(1.0))
    sched = S.linear_lr_warmup(S.polynomial_decay(lr, 8, lr * 0.1), 2,
                               lr * 0.1, lr)
    jax_side = params is None
    if kw.get("state_dtype") == "bf16":
        kw["state_dtype"] = jnp.bfloat16 if jax_side else torch.bfloat16
    for key in ("decay_mask_fn", "exclude_from_weight_decay_fn"):
        if key in kw and jax_side:
            kw[key] = _jax_mask(kw[key])
    opt = (getattr(lib, cls)(sched, **kw) if jax_side
           else getattr(lib, cls)(params, sched, **kw))
    if wrapper == "Lookahead":
        opt = lib.Lookahead(opt, alpha=0.5, k=2)
    elif wrapper == "RecomputeOptimizer":
        opt = lib.RecomputeOptimizer(opt)
    return opt


def _param_tol(key, lr):
    """A parameter's bar: :data:`PARAM_TOL`, but for the attention key
    biases, whose gradient is 0 in exact arithmetic (see the module
    docstring)."""
    if key.endswith("attn.bk"):
        return dict(rtol=0, atol=2 * lr * STEPS)
    return PARAM_TOL


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_optimizer_three_steps_match_jax_from_bridged_state(name):
    from paddle_tpu_torch import bridge
    jm, params, pm = _pair()
    jopt = _make(J, name, None)
    state = jopt.init(params)

    def jloss(p, x):
        return jm.apply({"params": p, "state": {}}, x, method="loss"), 0.0

    jstep = jax.jit(lambda p, s, x: jopt.minimize(jloss, p, s, x))
    # one JAX step first, so that the carried slots are not zero
    _, params, state, _ = jstep(params, state, jnp.asarray(_ids(0)))
    bridge.load_params(pm, _np(params))
    popt = _make(P, name, list(pm.named_parameters()))
    bridge.load_opt_state(popt, pm, _np(state))
    for i in range(STEPS):
        ids = _ids(i + 1)
        jl, params, state, _ = jstep(params, state, jnp.asarray(ids))
        pl = popt.minimize(pm, lambda m, x: m.loss(x), t(ids))
        np.testing.assert_allclose(float(pl), float(jl), **TOL)
    # the loss after the last update holds that update too
    final = _ids(STEPS + 1)
    with torch.no_grad():
        np.testing.assert_allclose(
            float(pm.loss(t(final))),
            float(jm.apply({"params": params, "state": {}},
                           jnp.asarray(final), method="loss")), **TOL)
    want = _flat(params)
    lr = OPTIMIZERS[name][0]
    for key, p in pm.named_parameters():
        np.testing.assert_allclose(n(p), want[key], **_param_tol(key, lr),
                                   err_msg=key)
    exported = bridge.export_opt_state(popt, pm)
    theirs, ours = _flat(state), bridge.flatten(exported)
    assert set(theirs) == set(ours)
    for key in theirs:
        if np.asarray(theirs[key]).ndim == 0:      # step counts
            assert int(ours[key]) == int(theirs[key]), key
    for key in [k for k in theirs if k.startswith("slow.")]:
        # Lookahead's slow weights are parameters: the parameters' bar
        np.testing.assert_allclose(ours[key], theirs[key],
                                   **_param_tol(key, lr), err_msg=key)
    slots = {k.rpartition(".")[2] for k in theirs
             if np.asarray(theirs[k]).ndim and not k.startswith("slow.")}
    for slot in slots:
        keys = [k for k in theirs if k.rpartition(".")[2] == slot
                and np.asarray(theirs[k]).ndim and not k.startswith("slow.")]
        top = max(float(np.abs(np.asarray(theirs[k], np.float32)).max())
                  for k in keys)
        # a slot stored in bf16 may round the other way once per step,
        # 2^-7 relative at most each (4 steps: 2^-5); an f32 one takes
        # the f32 bar
        rtol = 2.0 ** -5 if theirs[keys[0]].dtype.name == "bfloat16" \
            else 1e-4
        for key in keys:
            np.testing.assert_allclose(
                ours[key], np.asarray(theirs[key], np.float32), rtol=rtol,
                atol=1e-5 * top, err_msg=key)
    # the bridge round-trips the port's own state exactly
    again = _make(P, name, list(pm.named_parameters()))
    bridge.load_opt_state(again, pm, exported)
    for key, val in bridge.flatten(bridge.export_opt_state(again,
                                                           pm)).items():
        np.testing.assert_array_equal(val, ours[key], err_msg=key)


@pytest.mark.parametrize("which", ["ema", "model_average"])
def test_averages_match_jax(which):
    from paddle_tpu_torch import bridge
    rs = np.random.RandomState(3)
    trees = [_grad_tree(10 + i) for i in range(7)]
    live = {k: torch.zeros(v.shape) for k, v in trees[0].items()}
    with torch.no_grad():
        for k, v in live.items():
            v.copy_(t(trees[0][k]))
    if which == "ema":
        javg, pavg = J.ExponentialMovingAverage(0.9), \
            P.ExponentialMovingAverage(live.items(), 0.9)
    else:
        kw = dict(average_window_rate=0.5, min_average_window=2,
                  max_average_window=3)
        javg, pavg = J.ModelAverage(**kw), P.ModelAverage(live.items(), **kw)
    st = javg.init({k: jnp.asarray(v) for k, v in trees[0].items()})
    for tree in trees[1:]:
        with torch.no_grad():
            for k, v in live.items():
                v.copy_(t(tree[k]) + float(rs.rand()))
        st = javg.update(st, {k: jnp.asarray(n(v)) for k, v in live.items()})
        pavg.update()
    want, got = javg.apply(st), pavg.apply()
    for k in live:
        np.testing.assert_allclose(n(got[k]), np.asarray(want[k]),
                                   rtol=1e-6, atol=1e-6, err_msg=k)

    class Holder(torch.nn.Module):
        def __init__(self):
            super().__init__()
            for k, v in live.items():
                self.register_parameter(k, torch.nn.Parameter(v))

    holder = Holder()
    exported = bridge.export_opt_state(pavg, holder)
    for key, val in _flat(st).items():
        np.testing.assert_allclose(bridge.flatten(exported)[key], val,
                                   rtol=1e-6, atol=1e-6, err_msg=key)
    bridge.load_opt_state(pavg, holder, _np(st))


def test_check_nan_inf_raises_before_any_update():
    import paddle_tpu as pt
    from paddle_tpu_torch.core.enforce import EnforceError
    from paddle_tpu_torch.optimizer import Adam
    _, params, pm = _pair()
    popt = Adam(pm.named_parameters(), 1e-3, check_nan_inf=True)
    before = {k: p.detach().clone() for k, p in pm.named_parameters()}
    pm.zero_grad()
    pm.loss(t(_ids(0))).backward()
    pm.blocks[0].fc1.weight.grad[0, 0] = float("nan")
    with pytest.raises(EnforceError, match="blocks.0.fc1.weight"):
        popt.step()
    assert popt.step_count == 0
    for k, p in pm.named_parameters():
        assert torch.equal(p, before[k]), k
    # the JAX package's eager call raises too
    saved = all_flags()
    try:
        set_flags({"check_nan_inf": True})
        jopt = pt.optimizer.Adam(1e-3)
        grads = jax.tree_util.tree_map(jnp.zeros_like, params)
        fc1 = grads["blocks"]["0"]["fc1"]
        fc1["weight"] = fc1["weight"].at[0, 0].set(jnp.nan)
        with pytest.raises(Exception, match="non-finite"):
            jopt.apply_gradients(params, grads, jopt.init(params))
    finally:
        set_flags(saved)


def test_gated_step_refuses_a_nonfinite_loss_bit_for_bit():
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.optimizer import Adam, Gate, Lookahead
    _, _, pm = _pair()
    opt = amp.decorate(Lookahead(Adam(pm.parameters(), 1e-3), k=1),
                       amp.bf16_policy())
    opt.minimize(pm, lambda m, x: m.loss(x), t(_ids(0)))
    named = dict(pm.named_parameters())
    before = [x.clone() for x in [*named.values()] + [
        v for s in opt.inner.inner.state.values() for v in s.values()]
        + list(opt.inner.slow.values())]
    loss, applied = opt.minimize_gated(
        Gate(), pm, lambda m, x: m.loss(x) * float("nan"), t(_ids(1)))
    assert not bool(applied) and not torch.isfinite(loss)
    after = [*named.values()] + [
        v for s in opt.inner.inner.state.values() for v in s.values()] + \
        list(opt.inner.slow.values())
    assert all(torch.equal(a, b) for a, b in zip(before, after))
    assert opt.inner.inner.step_count == 1 and int(opt.inner._step) == 1
    # a healthy gated step equals the ungated one bit for bit
    _, _, pm2 = _pair()
    ref = amp.decorate(Lookahead(Adam(pm2.parameters(), 1e-3), k=1),
                       amp.bf16_policy())
    ref.minimize(pm2, lambda m, x: m.loss(x), t(_ids(0)))
    loss, applied = opt.minimize_gated(Gate(), pm, lambda m, x: m.loss(x),
                                       t(_ids(1)))
    ref_loss = ref.minimize(pm2, lambda m, x: m.loss(x), t(_ids(1)))
    assert bool(applied) and torch.equal(loss, ref_loss)
    for (k, a), b in zip(pm.named_parameters(), pm2.parameters()):
        assert torch.equal(a, b), k
    # Dpsgd's noise generator is part of the state a refused step keeps
    from paddle_tpu_torch.optimizer import Dpsgd
    opt = Dpsgd(pm.parameters(), 0.05, sigma=1.0)
    opt.minimize_gated(Gate(), pm, lambda m, x: m.loss(x), t(_ids(0)))
    before = opt.generator.get_state()
    named = dict(pm.named_parameters())
    weights = [p.detach().clone() for p in named.values()]
    _, applied = opt.minimize_gated(
        Gate(), pm, lambda m, x: m.loss(x) * float("nan"), t(_ids(1)))
    assert not bool(applied)
    assert torch.equal(opt.generator.get_state(), before)
    assert all(torch.equal(a, b) for a, b in zip(named.values(), weights))
    # the next applied step draws what the refused one would have drawn
    healthy = Dpsgd(pm2.parameters(), 0.05, sigma=1.0)
    healthy.generator.set_state(before)
    healthy._step.fill_(opt.step_count)
    with torch.no_grad():
        for a, b in zip(pm2.parameters(), named.values()):
            a.copy_(b)
    opt.minimize_gated(Gate(), pm, lambda m, x: m.loss(x), t(_ids(2)))
    healthy.minimize(pm2, lambda m, x: m.loss(x), t(_ids(2)))
    for (k, a), b in zip(pm.named_parameters(), pm2.parameters()):
        assert torch.equal(a, b), k


def test_gate_checks_the_update_norm():
    """A finite loss whose update overflows is refused too."""
    from paddle_tpu_torch.optimizer import SGD, Gate
    w = torch.nn.Parameter(torch.tensor([1.0, 2.0]))
    opt = SGD([w], 1e38)
    model = torch.nn.Module()
    model.w = w
    loss, applied = opt.minimize_gated(
        Gate(), model, lambda m: (m.w * 1e3).sum())
    assert torch.isfinite(loss) and not bool(applied)
    assert torch.equal(w.detach(), torch.tensor([1.0, 2.0]))
    loss, applied = opt.minimize_gated(
        Gate(check_update_norm=False), model, lambda m: (m.w * 1e3).sum())
    assert bool(applied) and not torch.isfinite(w).all()


def test_dpsgd_noise_is_seeded_and_has_its_variance():
    from paddle_tpu_torch.optimizer import Dpsgd
    draws = []
    for seed in (5, 5, 6):
        w = torch.nn.Parameter(torch.zeros(20000))
        opt = Dpsgd([w], 1.0, clip=2.0, batch_size=4.0, sigma=1.5,
                    seed=seed)
        w.grad = torch.zeros_like(w)
        opt.step()
        draws.append(-w.detach().clone())
    assert torch.equal(draws[0], draws[1])
    assert not torch.equal(draws[0], draws[2])
    want = 1.5 * 2.0 / 4.0
    assert abs(float(draws[0].std()) / want - 1) < 0.03
    assert abs(float(draws[0].mean())) < 0.03 * want


@pytest.mark.parametrize("amp_inner", [False, True])
def test_recompute_with_dropout_gives_the_plain_gradients(amp_inner):
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.models.bert import BertConfig, BertForPretraining
    from paddle_tpu_torch.optimizer import Adam, RecomputeOptimizer
    cfg = BertConfig(vocab_size=64, hidden_size=32, num_layers=2,
                     num_heads=2, intermediate_size=64, max_position=32,
                     dropout=0.1)
    rs = np.random.RandomState(0)
    ids = t(rs.randint(0, 64, (2, 16)))
    labels = t(rs.randint(0, 64, (2, 16)))
    nsp = t(rs.randint(0, 2, (2,)))
    mask = t((rs.rand(2, 16) < 0.3).astype(np.float32))
    runs = []
    for recompute in (False, True):
        m = BertForPretraining(cfg, device="cpu", seed=3)
        opt = Adam(m.parameters(), 1e-3)
        if amp_inner:
            opt = amp.decorate(opt, amp.bf16_policy())
        if recompute:
            opt = RecomputeOptimizer(opt)
        losses = [opt.minimize(m, lambda mm, *a: mm.loss(*a), ids, labels,
                               nsp, mask) for _ in range(2)]
        runs.append((losses, {k: p.grad for k, p in m.named_parameters()
                              if p.grad is not None},
                     m.dropout_gen.get_state()))
    (l0, g0, s0), (l1, g1, s1) = runs
    assert all(torch.equal(a, b) for a, b in zip(l0, l1))
    assert sorted(g0) == sorted(g1) and len(g0) > 20
    for k in g0:
        assert torch.equal(g0[k], g1[k]), k
    assert torch.equal(s0, s1)
