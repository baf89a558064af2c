"""The PyTorch port's training step against the JAX reference, on the CPU.

The same inputs, made with numpy from a seed, go through the JAX function
and its counterpart in the port (the plain versions of the kernels, since
the tensors lie on the CPU). The JAX side runs its XLA path and, where it
reaches a Pallas kernel, the kernel in interpret mode.

The model is ``GPTConfig(vocab_size=300, hidden_size=128, num_layers=2,
num_heads=2, intermediate_size=256, max_position=64)`` at T = 40: head
dim 64, so the JAX flash path engages under interpret mode, and the
shifted labels give 2 x 39 = 78 ragged rows against a ragged vocab tail.

Tolerances (f32): 1e-5 per op (kernel math, sums in another order); the
loss within 1e-5; whole-model gradients within 1e-4 abs + rel (two layers
of products and the vocab head compound the per-op rounding); Adam
parameters within 2 * lr * steps (where a gradient is near 0, Adam moves
a parameter by about lr in the gradient's sign, and that sign is noise);
bf16 loss within 2e-2 and the gradient within 5e-2 relative L2 (bf16
rounds at other places in the two frameworks).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.core.flags import all_flags, set_flags

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)
T = 40


@pytest.fixture
def flags_guard():
    saved = all_flags()
    yield
    set_flags(saved)


def _mode(mode):
    if mode == "interpret":
        set_flags({"pallas_interpret": True})


def t(a):
    return torch.from_numpy(np.array(np.asarray(a)))


def n(x):
    return x.detach().float().numpy()


def _cfgs():
    from paddle_tpu.models.gpt import GPTConfig
    from paddle_tpu_torch.models.gpt import GPTConfig as PConfig
    kw = dict(vocab_size=300, hidden_size=128, num_layers=2, num_heads=2,
              intermediate_size=256, max_position=64, dropout=0.0)
    return GPTConfig(**kw), PConfig(**kw)


def _pair(seed=0):
    """(jax model, jax params, port model) with identical weights."""
    from paddle_tpu.models.gpt import GPT
    from paddle_tpu_torch import bridge
    from paddle_tpu_torch.models.gpt import GPT as PGPT
    jcfg, pcfg = _cfgs()
    jm = GPT(jcfg)
    params = jm.init(jax.random.key(seed))["params"]
    pm = PGPT(pcfg, device="cpu", seed=seed + 7)
    bridge.load_params(pm, jax.tree_util.tree_map(np.asarray, params))
    return jm, params, pm


def _ids(rng, batch=2):
    return rng.randint(0, 300, (batch, T)).astype(np.int32)


def _jax_loss(jm, pad_id=None):
    def f(p, ids):
        return jm.apply({"params": p, "state": {}}, ids, method="loss",
                        pad_id=pad_id)
    return f


def _port_grads(pm):
    return {name: n(p.grad) for name, p in pm.named_parameters()}


def _flat(tree):
    from paddle_tpu_torch import bridge
    return bridge.flatten(jax.tree_util.tree_map(np.asarray, tree))


# ------------------------------------------------------------ K3 backward

@pytest.mark.parametrize("b,h,tq,tk,d,causal,masked", [
    (2, 2, 40, 40, 64, True, False),      # causal, several blocks
    (1, 2, 24, 56, 64, True, False),      # tq != tk: bottom-right offset
    (2, 2, 40, 40, 64, False, True),      # kv mask, one fully masked row
    (1, 3, 37, 45, 32, True, True),       # tails of both sequences
])
def test_flash_backward_plain_matches_pallas_interpret(rng, b, h, tq, tk, d,
                                                       causal, masked):
    from paddle_tpu.ops.pallas.flash_attention import (
        _flash_attention_bwd_tpu, _flash_attention_fwd_tpu)
    from paddle_tpu_torch.ops.cuda.flash_attention import (
        chunked_attention, flash_attention_bwd_plain)
    q = rng.randn(b, h, tq, d).astype(np.float32)
    k = rng.randn(b, h, tk, d).astype(np.float32)
    v = rng.randn(b, h, tk, d).astype(np.float32)
    do = rng.randn(b, h, tq, d).astype(np.float32)
    mask = None
    if masked:
        mask = np.ones((b, tk), bool)
        mask[0, tk // 3:] = False
        mask[-1] = False                       # every row of it masked
    scale = d ** -0.5
    jmask = None if mask is None else jnp.asarray(mask)
    out, lse = _flash_attention_fwd_tpu(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale, causal, 16,
        16, kv_mask=jmask, interpret=True, return_lse=True)
    want = _flash_attention_bwd_tpu(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), out, lse,
        jnp.asarray(do), scale, causal, 16, 16, kv_mask=jmask,
        interpret=True)
    tmask = None if mask is None else t(mask)
    pout, plse = chunked_attention(t(q), t(k), t(v), scale, causal, tmask,
                                   return_lse=True)
    np.testing.assert_allclose(n(pout), np.asarray(out), **TOL)
    if not masked:
        np.testing.assert_allclose(n(plse), np.asarray(lse), **TOL)
    got = flash_attention_bwd_plain(t(q), t(k), t(v), t(out), t(lse), t(do),
                                    scale, causal, tmask)
    for name, g_, w_ in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(n(g_), np.asarray(w_), err_msg=name,
                                   **TOL)
    if masked:
        assert float(got[0][-1].abs().max()) == 0.0   # masked rows: dq = 0


def test_flash_function_gradients_match_jax_vjp(rng, flags_guard):
    """FlashAttentionFunction's backward (the plain K3 on the CPU) against
    jax.vjp of the reference's flash_attention, on its XLA path and with
    the Pallas kernels in interpret mode."""
    from paddle_tpu.ops.pallas.flash_attention import flash_attention
    from paddle_tpu_torch.ops.cuda.flash_attention import (
        flash_attention as port_flash)
    q, k, v, do = (rng.randn(2, 2, 40, 64).astype(np.float32)
                   for _ in range(4))
    tq, tk, tv = (t(a).requires_grad_(True) for a in (q, k, v))
    port_flash(tq, tk, tv, causal=True).backward(t(do))
    for mode in ("xla", "interpret"):
        _mode(mode)
        _, vjp = jax.vjp(lambda a, b_, c: flash_attention(a, b_, c,
                                                          causal=True),
                         jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
        for name, g_, w_ in zip("qkv", (tq.grad, tk.grad, tv.grad),
                                vjp(jnp.asarray(do))):
            np.testing.assert_allclose(n(g_), np.asarray(w_),
                                       err_msg=f"{mode} d{name}", **TOL)


# ------------------------------------------------------- K5 / K6 xent

def _xent_inputs(rng, n_=78, v=300, hid=128):
    h = rng.randn(n_, hid).astype(np.float32)
    w = (rng.randn(v, hid) * 0.05).astype(np.float32)
    b = (rng.randn(v) * 0.1).astype(np.float32)
    labels = rng.randint(0, v, n_).astype(np.int32)
    labels[::7] = v + 5                      # out of range: never hit
    labels[3::11] = -1
    return h, w, b, labels


@pytest.mark.parametrize("hid", [128, 1024])     # 1024: BERT-large's width
@pytest.mark.parametrize("ls", [0.0, 0.1])
def test_xent_plain_versions_match_pallas_interpret(rng, ls, hid):
    from paddle_tpu.ops.fused import _smooth_consts
    from paddle_tpu.ops.pallas.xent import xent_bwd_pallas, xent_stats_pallas
    from paddle_tpu_torch.ops.cuda.xent import (xent_bwd_plain,
                                                xent_stats_plain)
    h, w, b, labels = _xent_inputs(rng, hid=hid)
    jh, jw, jb, jl = map(jnp.asarray, (h, w, b, labels))
    want = xent_stats_pallas(jh, jw, jb, jl, interpret=True,
                             return_parts=True, blocks=(32, 128))
    got = xent_stats_plain(t(h), t(w), t(b), t(labels))
    for name, g_, w_ in zip(("m", "s", "picked", "sum_logits"), got, want):
        np.testing.assert_allclose(n(g_), np.asarray(w_), err_msg=name,
                                   **TOL)
    logz = (got[0] + torch.log(got[1])).numpy()
    g = (rng.randn(h.shape[0]) * 0.1).astype(np.float32)
    sn, sp = _smooth_consts(w.shape[0], ls)
    want = xent_bwd_pallas(jh, jw, jb, jl, jnp.asarray(logz), jnp.asarray(g),
                           sn, sp, interpret=True)
    got = xent_bwd_plain(t(h), t(w), t(b), t(labels), t(logz), t(g), sn, sp)
    for name, g_, w_ in zip(("dh", "dw", "db"), got, want):
        np.testing.assert_allclose(n(g_), np.asarray(w_), err_msg=name,
                                   **TOL)


@pytest.mark.parametrize("mode", ["xla", "interpret"])
@pytest.mark.parametrize("ls", [0.0, 0.1])
def test_fused_xent_value_and_grad_match_jax(rng, flags_guard, mode, ls):
    from paddle_tpu.ops.fused import fused_xent
    from paddle_tpu_torch.ops.fused import fused_xent as port_xent
    h, w, b, labels = _xent_inputs(rng)
    labels = np.clip(labels, 0, w.shape[0] - 1).reshape(2, 39)
    h = h.reshape(2, 39, -1)
    g = (rng.randn(2, 39) * 0.1).astype(np.float32)
    _mode(mode)
    loss, vjp = jax.vjp(
        lambda a, c, d: fused_xent(a, c, jnp.asarray(labels), bias=d,
                                   label_smoothing=ls),
        jnp.asarray(h), jnp.asarray(w), jnp.asarray(b))
    th, tw, tb = (t(a).requires_grad_(True) for a in (h, w, b))
    ploss = port_xent(th, tw, t(labels), bias=tb, label_smoothing=ls)
    np.testing.assert_allclose(n(ploss), np.asarray(loss), **TOL)
    ploss.backward(t(g))
    for name, g_, w_ in zip(("dh", "dw", "db"), (th.grad, tw.grad, tb.grad),
                            vjp(jnp.asarray(g))):
        np.testing.assert_allclose(n(g_), np.asarray(w_), err_msg=name,
                                   **TOL)


def test_fused_xent_refuses_what_is_not_ported():
    """The vocab-sharded path raises in both layouts. The ``[H, V]``
    layout "hv" is ported (the Transformer's loss): on the transposed
    weight it gives the "vh" loss."""
    from paddle_tpu_torch.ops.fused import fused_xent
    g = torch.Generator().manual_seed(0)
    h, w = torch.randn(3, 8, generator=g), torch.randn(5, 8, generator=g)
    y = torch.tensor([0, 4, 2])
    torch.testing.assert_close(fused_xent(h, w.T, y, weight_layout="hv"),
                               fused_xent(h, w, y), rtol=1e-5, atol=1e-5)
    for layout, weight in (("vh", w), ("hv", w.T)):
        for kw in (dict(vocab_axis="tp"), dict(batch_axis="dp"),
                   dict(mesh="mesh")):
            with pytest.raises(NotImplementedError):
                fused_xent(h, weight, y, weight_layout=layout, **kw)


# ------------------------------------------------- LN and MLP backward

@pytest.mark.parametrize("mode", ["xla", "interpret"])
@pytest.mark.parametrize("shape", [(13, 48), (3, 5, 40)])
def test_layer_norm_function_matches_jax_vjp(rng, flags_guard, mode, shape):
    from paddle_tpu.ops.pallas.layer_norm import layer_norm_fused
    from paddle_tpu_torch.ops.cuda.layer_norm import (layer_norm_fused as
                                                      port_ln)
    c = shape[-1]
    x = (rng.randn(*shape) * 3 + 1).astype(np.float32)
    g = rng.randn(c).astype(np.float32)
    b = rng.randn(c).astype(np.float32)
    dy = rng.randn(*shape).astype(np.float32)
    axis = len(shape) - 1
    _mode(mode)
    y, vjp = jax.vjp(lambda a, s, o: layer_norm_fused(
        a, s, o, begin_norm_axis=axis), *map(jnp.asarray, (x, g, b)))
    tx, tg, tb = (t(a).requires_grad_(True) for a in (x, g, b))
    py = port_ln(tx, tg, tb, begin_norm_axis=axis)
    np.testing.assert_allclose(n(py), np.asarray(y), **TOL)
    py.backward(t(dy))
    for name, g_, w_ in zip(("dx", "dscale", "dbias"),
                            (tx.grad, tg.grad, tb.grad),
                            vjp(jnp.asarray(dy))):
        np.testing.assert_allclose(n(g_), np.asarray(w_), err_msg=name,
                                   **TOL)


@pytest.mark.parametrize("mode", ["xla", "interpret"])
def test_mlp_function_matches_jax_vjp(rng, flags_guard, mode):
    from paddle_tpu.ops.pallas.mlp import fused_mlp
    from paddle_tpu_torch.ops.cuda.mlp import fused_mlp as port_mlp
    x = rng.randn(2, 7, 32).astype(np.float32)
    w1 = (rng.randn(32, 72) * 0.2).astype(np.float32)
    b1 = (rng.randn(72) * 0.1).astype(np.float32)
    w2 = (rng.randn(72, 32) * 0.2).astype(np.float32)
    b2 = (rng.randn(32) * 0.1).astype(np.float32)
    dy = rng.randn(2, 7, 32).astype(np.float32)
    _mode(mode)
    y, vjp = jax.vjp(fused_mlp, *map(jnp.asarray, (x, w1, b1, w2, b2)))
    leaves = [t(a).requires_grad_(True) for a in (x, w1, b1, w2, b2)]
    py = port_mlp(*leaves)
    np.testing.assert_allclose(n(py), np.asarray(y), **TOL)
    py.backward(t(dy))
    for name, g_, w_ in zip(("x", "w1", "b1", "w2", "b2"), leaves,
                            vjp(jnp.asarray(dy))):
        np.testing.assert_allclose(n(g_.grad), np.asarray(w_),
                                   err_msg=name, **TOL)


# --------------------------------------------------------------- GPT.loss

@pytest.mark.parametrize("mode", ["xla", "interpret"])
@pytest.mark.parametrize("pad_id", [None, 7])
def test_gpt_loss_value_and_grads_match_jax(rng, flags_guard, mode, pad_id):
    jm, params, pm = _pair()
    ids = _ids(rng)
    if pad_id is not None:
        ids[0, -9:] = pad_id                   # a padded tail
    _mode(mode)
    jl, jg = jax.value_and_grad(_jax_loss(jm, pad_id))(params,
                                                        jnp.asarray(ids))
    pl = pm.loss(t(ids), pad_id=pad_id)
    pl.backward()
    np.testing.assert_allclose(pl.item(), float(jl), **TOL)
    want = _flat(jg)
    got = _port_grads(pm)
    assert set(got) == set(want)
    for name in want:
        np.testing.assert_allclose(got[name], want[name], err_msg=name,
                                   **GRAD_TOL)


def test_gpt_loss_equals_lm_loss_of_the_logits(rng):
    """The fused loss against the logits-then-lm_loss composition, in the
    port and in the reference."""
    from paddle_tpu.models.gpt import lm_loss as jax_lm_loss
    from paddle_tpu_torch.models.gpt import lm_loss
    jm, params, pm = _pair()
    ids = _ids(rng)
    ids[1, :5] = 3
    for pad_id in (None, 3):
        fused = float(pm.loss(t(ids), pad_id=pad_id))
        with torch.no_grad():
            plain = float(lm_loss(pm(t(ids)), t(ids), pad_id))
        logits = jm.apply({"params": params, "state": {}}, jnp.asarray(ids))
        ref = float(jax_lm_loss(logits, jnp.asarray(ids), pad_id))
        np.testing.assert_allclose(fused, plain, **TOL)
        np.testing.assert_allclose(plain, ref, **TOL)


def test_gpt_loss_refuses_sharding():
    from paddle_tpu_torch.models.gpt import GPT
    _, pcfg = _cfgs()
    m = GPT(pcfg, device="cpu")
    with pytest.raises(TypeError):            # no sharding arguments yet
        m.loss(torch.zeros(1, 8, dtype=torch.long), vocab_axis="tp")


# ------------------------------------------------------------- optimizer

def test_adam_three_steps_match_jax_from_bridged_state(rng):
    import paddle_tpu as pt
    from paddle_tpu_torch import bridge
    from paddle_tpu_torch.optimizer import Adam
    jm, params, pm = _pair()
    ids = _ids(rng)
    lr = 1e-3
    jopt = pt.optimizer.Adam(lr)
    jstate = jopt.init(params)
    loss_fn = _jax_loss(jm)

    def jloss(p, x):
        return loss_fn(p, x), 0.0

    # one step on the JAX side first, so the carried moments are not zero
    _, params, jstate, _ = jopt.minimize(jloss, params, jstate,
                                         jnp.asarray(ids))
    np_tree = lambda tr: jax.tree_util.tree_map(np.asarray, tr)  # noqa: E731
    bridge.load_params(pm, np_tree(params))
    popt = Adam(pm.parameters(), lr)
    bridge.load_opt_state(popt, pm, np_tree(jstate))
    assert popt.step_count == 1
    steps = 3
    for _ in range(steps):
        jl, params, jstate, _ = jopt.minimize(jloss, params, jstate,
                                              jnp.asarray(ids))
        pl = popt.minimize(pm, lambda m, x: m.loss(x), t(ids))
        np.testing.assert_allclose(float(pl), float(jl), **TOL)
    # the loss after the last update holds that update too
    with torch.no_grad():
        np.testing.assert_allclose(float(pm.loss(t(ids))),
                                   float(loss_fn(params, jnp.asarray(ids))),
                                   **TOL)
    want = _flat(params)
    for name, p in pm.named_parameters():
        np.testing.assert_allclose(n(p), want[name], rtol=0,
                                   atol=2 * lr * steps, err_msg=name)
    exported = bridge.export_opt_state(popt, pm)
    assert int(exported["step"]) == int(jstate["step"]) == 1 + steps
    theirs, ours = _flat(jstate["slots"]), bridge.flatten(exported["slots"])
    assert set(theirs) == set(ours)
    # each moment within 1e-4 relative, plus 1e-5 of its slot's largest
    # value over all parameters (the key bias's gradient is rounding noise)
    for slot in ("moment1", "moment2"):
        keys = [k for k in theirs if k.endswith(slot)]
        top = max(float(np.abs(theirs[k]).max()) for k in keys)
        for key in keys:
            np.testing.assert_allclose(ours[key], theirs[key], rtol=1e-4,
                                       atol=1e-5 * top, err_msg=key)


def test_opt_state_bridge_round_trip_and_amp_nesting(rng):
    from paddle_tpu_torch import amp, bridge
    from paddle_tpu_torch.optimizer import Adam
    _, _, pm = _pair()
    opt = amp.decorate(Adam(pm.parameters(), 1e-3, state_dtype=torch.bfloat16),
                       amp.bf16_policy())
    opt.minimize(pm, lambda m, x: m.loss(x), t(_ids(rng)))
    state = bridge.export_opt_state(opt, pm)
    assert set(state) == {"inner"} and int(state["inner"]["step"]) == 1
    leaf = state["inner"]["slots"]["tok_emb"]["weight"]
    assert leaf["moment2"].dtype == np.float32     # moment2 pinned to f32
    opt2 = amp.decorate(Adam(pm.parameters(), 1e-3,
                             state_dtype=torch.bfloat16), amp.bf16_policy())
    bridge.load_opt_state(opt2, pm, state)
    again = bridge.flatten(bridge.export_opt_state(opt2, pm)["inner"])
    for key, val in bridge.flatten(state["inner"]).items():
        np.testing.assert_array_equal(again[key], val, err_msg=key)
    p = pm.tok_emb.weight
    assert opt2.inner.state[p]["moment1"].dtype == torch.bfloat16
    with pytest.raises(KeyError):
        bridge.load_opt_state(opt2, pm, state["inner"])


def test_bf16_policy_step_matches_jax_amp(rng):
    import paddle_tpu as pt
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.optimizer import Adam
    jm, params, pm = _pair()
    ids = _ids(rng)
    policy = pt.amp.bf16_policy()
    jopt = pt.amp.decorate(pt.optimizer.Adam(1e-3), policy)
    loss_fn = _jax_loss(jm)
    jl, _, _, _ = jopt.minimize(lambda p, x: (loss_fn(p, x), 0.0), params,
                                jopt.init(params), jnp.asarray(ids))
    jg = jax.grad(lambda p: loss_fn(policy.cast_to_compute(p),
                                    jnp.asarray(ids)).astype(jnp.float32))(
        params)
    popt = amp.decorate(Adam(pm.parameters(), 1e-3), amp.bf16_policy())
    pl = popt.minimize(pm, lambda m, x: m.loss(x), t(ids))
    assert abs(float(pl) - float(jl)) <= 2e-2
    want = _flat(jg)
    got = _port_grads(pm)
    assert all(p.grad.dtype == torch.float32 for p in pm.parameters())
    assert all(p.dtype == torch.float32 for p in pm.parameters())
    diff = sum(float(((got[k] - want[k].astype(np.float32)) ** 2).sum())
               for k in want)
    norm = sum(float((want[k].astype(np.float32) ** 2).sum()) for k in want)
    assert (diff / norm) ** 0.5 <= 5e-2


def test_optimizer_refuses_what_is_not_ported():
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.optimizer import Adam
    w = torch.nn.Parameter(torch.zeros(3))
    with pytest.raises(NotImplementedError):  # fp16 needs the loss scaler
        amp.decorate(Adam([w], 1e-3), amp.Policy(compute_dtype=torch.float16))
    with pytest.raises(NotImplementedError):
        amp.decorate(Adam([w], 1e-3), amp.bf16_policy(), scaler=object())
    with pytest.raises(NotImplementedError):
        amp.LossScaler()


# ---------------------------------------------------------------- dropout

def test_dropout_mask_repeats_with_the_same_generator():
    from paddle_tpu_torch.core.enforce import EnforceError
    from paddle_tpu_torch.nn import Dropout
    x = torch.ones(64, 64)
    d = Dropout(0.3, gen=torch.Generator().manual_seed(5))
    a = d(x)
    b = d(x)                                   # the generator moved on
    d.gen = torch.Generator().manual_seed(5)
    assert torch.equal(d(x), a) and not torch.equal(a, b)
    kept = a[a != 0]
    np.testing.assert_allclose(n(kept), 1 / 0.7, rtol=1e-6)
    assert 0.6 < kept.numel() / a.numel() < 0.8
    with pytest.raises(EnforceError):
        Dropout(0.3)(x)
    assert torch.equal(Dropout(0.3).eval()(x), x)


def test_gpt_dropout_is_seeded_by_the_model():
    from paddle_tpu_torch.models.gpt import GPT
    _, pcfg = _cfgs()
    pcfg.dropout = 0.1
    ids = torch.randint(0, 300, (2, T), generator=torch.Generator()
                        .manual_seed(0))
    losses = [float(GPT(pcfg, device="cpu", seed=3).loss(ids))
              for _ in range(2)]
    m = GPT(pcfg, device="cpu", seed=3)
    assert losses[0] == losses[1]
    assert float(m.eval().loss(ids)) != losses[0]
