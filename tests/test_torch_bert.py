"""The PyTorch port's BERT/ERNIE pretraining path against the JAX reference,
on the CPU.

The same inputs, made with numpy from a seed, go through the JAX function
and its counterpart in the port (the plain versions of the kernels, since
the tensors lie on the CPU). The JAX side runs its XLA path and, where it
reaches a Pallas kernel, the kernel in interpret mode.

The model is ``BertConfig(vocab_size=300, hidden_size=128, num_layers=2,
num_heads=2, intermediate_size=256, max_position=64)`` at B x T = 2 x 40:
head dim 64, so the JAX flash path engages under interpret mode. The
batch pads row 0 after 30 tokens (a key-padding mask), has token types
and gathers 6 masked positions per row.

Tolerances (f32): 1e-5 per op (kernel math, sums in another order); the
loss within 1e-5; logits within 1e-4 and whole-model gradients within
1e-4 abs + rel (two layers of products and the vocab head compound the
per-op rounding); Adam parameters within 2 * lr * steps (where a gradient
is near 0, Adam moves a parameter by about lr in the gradient's sign, and
that sign is noise); bf16 loss within 2e-2 and the gradient within 5e-2
relative L2 (bf16 rounds at other places in the two frameworks). The
fused add + layer norm in bf16 is held within 3e-2: the port (like the
Pallas kernel) keeps the sum x + h in f32, the reference's XLA twin
rounds it to bf16 first, and one bf16 rounding of order-1 values is
≈ 4e-3.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.core.flags import all_flags, set_flags

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)
BF16_TOL = dict(rtol=0, atol=3e-2)
B, T, M = 2, 40, 6
KW = dict(vocab_size=300, hidden_size=128, num_layers=2, num_heads=2,
          intermediate_size=256, max_position=64, dropout=0.0)


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


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _flat(tree):
    from paddle_tpu_torch import bridge
    return bridge.flatten(_np_tree(tree))


def _pair(model="bert", seed=0, **over):
    """(jax model, jax params, port model) with identical weights."""
    from paddle_tpu_torch import bridge
    if model == "bert":
        from paddle_tpu.models.bert import BertConfig as JC
        from paddle_tpu.models.bert import BertForPretraining as JM
        from paddle_tpu_torch.models.bert import BertConfig as PC
        from paddle_tpu_torch.models.bert import BertForPretraining as PM
    else:
        from paddle_tpu.models.ernie import ErnieConfig as JC
        from paddle_tpu.models.ernie import ErnieForPretraining as JM
        from paddle_tpu_torch.models.ernie import ErnieConfig as PC
        from paddle_tpu_torch.models.ernie import ErnieForPretraining as PM
    kw = dict(KW, **over)
    jm = JM(JC(**kw))
    params = jm.init(jax.random.key(seed))["params"]
    pm = PM(PC(**dict(kw, scan_layers=False)), device="cpu", seed=seed + 7)
    bridge.load_params(pm, _np_tree(params))
    return jm, params, pm


def _batch(rng, vocab=300):
    """(ids, mlm_labels, nsp_labels, mlm_mask, token_type_ids,
    attention_mask, mask_positions) as numpy arrays."""
    ids = rng.randint(0, vocab, (B, T)).astype(np.int32)
    types = np.zeros((B, T), np.int32)
    types[:, 22:] = 1
    att = np.ones((B, T), np.float32)
    att[0, 30:] = 0.0                      # row 0 padded after 30 tokens
    pos = np.stack([np.sort(rng.choice(30, M, replace=False))
                    for _ in range(B)]).astype(np.int32)
    mlm_labels = rng.randint(0, vocab, (B, M)).astype(np.int32)
    nsp_labels = rng.randint(0, 2, (B,)).astype(np.int32)
    mlm_mask = np.ones((B, M), np.float32)
    mlm_mask[1, -2:] = 0.0
    return ids, mlm_labels, nsp_labels, mlm_mask, types, att, pos


def _jax_loss(jm, batch):
    ids, ml, nl, mm, types, att, pos = map(jnp.asarray, batch)

    def f(p):
        return jm.apply({"params": p, "state": {}}, ids, ml, nl, mm,
                        token_type_ids=types, attention_mask=att,
                        mask_positions=pos, method="loss")
    return f


def _port_loss(pm, batch):
    ids, ml, nl, mm, types, att, pos = map(t, batch)
    return pm.loss(ids, ml, nl, mm, token_type_ids=types, attention_mask=att,
                   mask_positions=pos)


# ------------------------------------------------- K8 add + layer norm

def _add_ln_inputs(rng, shape):
    c = shape[-1]
    x = (rng.randn(*shape) * 3 + 1).astype(np.float32)
    h = rng.randn(*shape).astype(np.float32)
    g = (rng.randn(c) * 0.1 + 1).astype(np.float32)
    b = (rng.randn(c) * 0.1).astype(np.float32)
    return x, h, g, b


@pytest.mark.parametrize("path", ["pallas_interpret", "xla"])
@pytest.mark.parametrize("rows,cols", [(13, 48), (37, 96), (5, 200)])
def test_add_layer_norm_plain_matches_jax_f32(rng, path, rows, cols):
    from paddle_tpu.ops.pallas.layer_norm import _stats_add, _stats_add_pallas
    from paddle_tpu_torch.ops.cuda.layer_norm import add_layer_norm_plain
    x, h, g, b = _add_ln_inputs(rng, (rows, cols))
    args = tuple(map(jnp.asarray, (x, h, g, b)))
    if path == "pallas_interpret":
        want = _stats_add_pallas(*args, 1e-5, interpret=True)
    else:
        want = _stats_add(*args, 1e-5)
    got = add_layer_norm_plain(t(x), t(h), t(g), t(b), 1e-5)
    for name, g_, w_ in zip(("y", "mean", "rstd"), got, want):
        np.testing.assert_allclose(n(g_), np.asarray(w_), err_msg=name,
                                   **TOL)


@pytest.mark.parametrize("path", ["pallas_interpret", "xla"])
def test_add_layer_norm_plain_matches_jax_bf16(rng, path):
    """bf16 storage: the Pallas kernel keeps the sum in f32 as the port
    does; the XLA twin rounds the sum to bf16 before normalizing, which
    moves y by up to one bf16 rounding (the tolerance says so)."""
    from paddle_tpu.ops.pallas.layer_norm import _stats_add, _stats_add_pallas
    from paddle_tpu_torch.ops.cuda.layer_norm import add_layer_norm_plain
    x, h, g, b = (a.astype(jnp.bfloat16) for a in map(
        jnp.asarray, _add_ln_inputs(rng, (24, 128))))
    if path == "pallas_interpret":
        want = _stats_add_pallas(x, h, g, b, 1e-5, interpret=True)
    else:
        want = _stats_add(x, h, g, b, 1e-5)
    tt = [t(a.astype(jnp.float32)).to(torch.bfloat16) for a in (x, h, g, b)]
    got = add_layer_norm_plain(*tt, 1e-5)
    assert got[0].dtype == torch.bfloat16
    for name, g_, w_ in zip(("y", "mean", "rstd"), got, want):
        np.testing.assert_allclose(n(g_), np.asarray(w_).astype(np.float32),
                                   err_msg=name, **BF16_TOL)


@pytest.mark.parametrize("mode", ["xla", "interpret"])
@pytest.mark.parametrize("shape", [(13, 48), (3, 5, 40)])
def test_add_layer_norm_function_matches_jax_vjp(rng, flags_guard, mode,
                                                 shape):
    from paddle_tpu.ops.pallas.layer_norm import add_layer_norm_fused
    from paddle_tpu_torch.ops.cuda.layer_norm import (
        add_layer_norm_fused as port_aln)
    x, h, g, b = _add_ln_inputs(rng, shape)
    dy = rng.randn(*shape).astype(np.float32)
    axis = len(shape) - 1
    _mode(mode)
    y, vjp = jax.vjp(lambda a, c, s, o: add_layer_norm_fused(
        a, c, s, o, begin_norm_axis=axis), *map(jnp.asarray, (x, h, g, b)))
    leaves = [t(a).requires_grad_(True) for a in (x, h, g, b)]
    py = port_aln(*leaves, begin_norm_axis=axis)
    np.testing.assert_allclose(n(py), np.asarray(y), **TOL)
    py.backward(t(dy))
    for name, g_, w_ in zip(("dx", "dh", "dscale", "dbias"), leaves,
                            vjp(jnp.asarray(dy))):
        np.testing.assert_allclose(n(g_.grad), np.asarray(w_),
                                   err_msg=name, **TOL)


def test_layer_norm_residual_is_the_fused_add(rng):
    from paddle_tpu_torch.nn import LayerNorm
    x, h, _, _ = _add_ln_inputs(rng, (2, 7, 48))
    ln = LayerNorm(48)
    torch.testing.assert_close(ln(t(x), residual=t(h)), ln(t(x) + t(h)),
                               rtol=1e-5, atol=1e-5)


# -------------------------------------------- key-padding masks (repair)

@pytest.mark.parametrize("shape", [(2, 1, 1, 40), (1, 1, 40), (1, 40),
                                   (2, 40), (2, 1, 1, 39), (2, 2, 1, 40),
                                   (3, 1, 1, 40)])
def test_as_key_padding_mask_matches_jax(rng, shape):
    from paddle_tpu.ops.attention import _as_key_padding_mask as jax_kpm
    from paddle_tpu_torch.ops.attention import _as_key_padding_mask
    mask = (rng.rand(*shape) > 0.3).astype(np.float32)
    want = jax_kpm(jnp.asarray(mask), 2, 40)
    got = _as_key_padding_mask(t(mask), 2, 40)
    if want is None:
        assert got is None
    else:
        assert got.dtype == torch.bool and tuple(got.shape) == (2, 40)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _mha_inputs(rng, e=128):
    x = rng.randn(B, T, e).astype(np.float32)
    ws = [(rng.randn(e, e) * 0.1).astype(np.float32) for _ in range(4)]
    bs = [(rng.randn(e) * 0.1).astype(np.float32) for _ in range(4)]
    return x, ws, bs


@pytest.mark.parametrize("mode", ["xla", "interpret"])
@pytest.mark.parametrize("mask_shape", [(B, 1, 1, T), (1, T), (T, T)])
def test_masked_multihead_attention_matches_jax(rng, flags_guard,
                                                monkeypatch, mode,
                                                mask_shape):
    """A key-padding mask rides flash attention with ``kv_mask`` (as the
    reference routes it); a per-query ``[T, T]`` mask stays on the dense
    path. Output and gradients against JAX."""
    from paddle_tpu.ops.attention import multihead_attention as jax_mha
    from paddle_tpu_torch.ops import attention as att
    x, ws, bs = _mha_inputs(rng)
    mask = np.ones(mask_shape, np.float32)
    if mask_shape == (T, T):
        mask = np.tril(np.ones((T, T), np.float32), 5)
    else:
        mask[..., 29:] = 0.0
        if mask_shape[0] == B:
            mask[1, ..., 35:] = 0.0
    dy = rng.randn(B, T, 128).astype(np.float32)
    calls = []
    real = att.flash_attention
    monkeypatch.setattr(att, "flash_attention",
                        lambda *a, **k: calls.append(k) or real(*a, **k))
    _mode(mode)
    y, vjp = jax.vjp(
        lambda xx, wq, wk: jax_mha(xx, wq, wk, *map(jnp.asarray, ws[2:]),
                                   *map(jnp.asarray, bs), num_heads=2,
                                   mask=jnp.asarray(mask), use_flash=True),
        *map(jnp.asarray, (x, ws[0], ws[1])))
    leaves = [t(a).requires_grad_(True) for a in (x, ws[0], ws[1])]
    py = att.multihead_attention(leaves[0], leaves[1], leaves[2],
                                 *map(t, ws[2:]), *map(t, bs), 2,
                                 mask=t(mask), use_flash=True)
    assert len(calls) == (0 if mask_shape == (T, T) else 1)
    if calls:
        assert tuple(calls[0]["kv_mask"].shape) == (B, T)
    np.testing.assert_allclose(n(py), np.asarray(y), **TOL)
    py.backward(t(dy))
    for name, g_, w_ in zip(("x", "wq", "wk"), leaves, vjp(jnp.asarray(dy))):
        np.testing.assert_allclose(n(g_.grad), np.asarray(w_), err_msg=name,
                                   **TOL)


# ------------------------------------------------------------- layers

def test_linear_bias_and_activations_match_jax(rng):
    from paddle_tpu.nn.layers import Linear as JLinear
    from paddle_tpu.ops.activations import tanh as jax_tanh
    from paddle_tpu_torch import bridge
    from paddle_tpu_torch.nn import Linear
    from paddle_tpu_torch.ops.activations import tanh
    x = rng.randn(3, 5, 16).astype(np.float32)
    np.testing.assert_allclose(n(tanh(t(x))), np.asarray(jax_tanh(
        jnp.asarray(x))), **TOL)
    for bias, act in ((True, "gelu"), (True, "tanh"), (False, None)):
        jl = JLinear(16, 8, bias=bias, act=act)
        variables = jl.init(jax.random.key(1))
        pl = Linear(16, 8, bias=bias, act=act)
        assert (pl.bias is None) == (not bias)
        bridge.load_params(pl, _np_tree(variables["params"]))
        want = jl.apply(variables, jnp.asarray(x))
        with torch.no_grad():
            np.testing.assert_allclose(n(pl(t(x))), np.asarray(want), **TOL)


# --------------------------------------------------------------- BERT

@pytest.mark.parametrize("mode", ["xla", "interpret"])
def test_bert_forward_logits_match_jax(rng, flags_guard, mode):
    jm, params, pm = _pair()
    ids, _, _, _, types, att, pos = _batch(rng)
    _mode(mode)
    jmlm, jnsp = jm.apply({"params": params, "state": {}}, jnp.asarray(ids),
                          jnp.asarray(types), jnp.asarray(att),
                          jnp.asarray(pos))
    with torch.no_grad():
        pmlm, pnsp = pm(t(ids), t(types), t(att), t(pos))
    assert tuple(pmlm.shape) == (B, M, KW["vocab_size"])
    np.testing.assert_allclose(n(pmlm), np.asarray(jmlm), **LOGIT_TOL)
    np.testing.assert_allclose(n(pnsp), np.asarray(jnsp), **LOGIT_TOL)


@pytest.mark.parametrize("mode", ["xla", "interpret"])
def test_bert_loss_value_and_grads_match_jax(rng, flags_guard, mode):
    jm, params, pm = _pair()
    batch = _batch(rng)
    _mode(mode)
    jl, jg = jax.value_and_grad(_jax_loss(jm, batch))(params)
    pl = _port_loss(pm, batch)
    pl.backward()
    np.testing.assert_allclose(pl.item(), float(jl), **TOL)
    want = _flat(jg)
    got = {name: n(p.grad) for name, p in pm.named_parameters()}
    assert set(got) == set(want)
    for name in want:
        np.testing.assert_allclose(got[name], want[name], err_msg=name,
                                   **GRAD_TOL)


def test_bert_large_width_loss_and_grads_match_jax(rng, flags_guard):
    """BertConfig.large()'s width (H = 1024, 16 heads, I = 4096) at one
    layer and a small vocab: the width the cross-entropy kernels refused
    before, on the CPU plain path against JAX."""
    jm, params, pm = _pair(hidden_size=1024, num_heads=16, num_layers=1,
                           intermediate_size=4096)
    batch = _batch(rng)
    jl, jg = jax.value_and_grad(_jax_loss(jm, batch))(params)
    pl = _port_loss(pm, batch)
    pl.backward()
    np.testing.assert_allclose(pl.item(), float(jl), **TOL)
    want = _flat(jg)
    got = {name: n(p.grad) for name, p in pm.named_parameters()}
    assert set(got) == set(want)
    for name in want:
        np.testing.assert_allclose(got[name], want[name], err_msg=name,
                                   **GRAD_TOL)


def test_bert_loss_equals_pretrain_loss_of_the_logits(rng):
    """The fused loss against the logits-then-pretrain_loss composition,
    in the port and in the reference."""
    from paddle_tpu.models.bert import pretrain_loss as jax_pretrain_loss
    from paddle_tpu_torch.models.bert import pretrain_loss
    jm, params, pm = _pair()
    batch = _batch(rng)
    ids, ml, nl, mm, types, att, pos = batch
    with torch.no_grad():
        fused = float(_port_loss(pm, batch))
        mlm, nsp = pm(t(ids), t(types), t(att), t(pos))
        plain = float(pretrain_loss(mlm, nsp, t(ml), t(nl), t(mm)))
    jmlm, jnsp = jm.apply({"params": params, "state": {}}, jnp.asarray(ids),
                          jnp.asarray(types), jnp.asarray(att),
                          jnp.asarray(pos))
    ref = float(jax_pretrain_loss(jmlm, jnsp, *map(jnp.asarray,
                                                    (ml, nl, mm))))
    np.testing.assert_allclose(fused, plain, **TOL)
    np.testing.assert_allclose(plain, ref, **TOL)


def test_bert_from_a_scan_stacked_tree(rng):
    """The JAX package's scan_layers tree (layers stacked under
    encoder/layers/layer) bridges into the port's unrolled layers."""
    from paddle_tpu_torch import bridge
    jm, params, pm = _pair(scan_layers=True)
    assert "layer" in params["encoder"]["layers"]
    batch = _batch(rng)
    want = float(_jax_loss(jm, batch)(params))
    with torch.no_grad():
        np.testing.assert_allclose(float(_port_loss(pm, batch)), want,
                                   **TOL)
    stacked = _flat(params)["encoder.layers.layer.fc1.weight"]
    unrolled = bridge.flatten(bridge.export_params(pm))
    for i in range(KW["num_layers"]):
        np.testing.assert_array_equal(
            unrolled[f"encoder.layers.{i}.fc1.weight"], stacked[i])


def test_bert_refuses_what_is_not_ported():
    """scan_layers and remat are ported (tests/test_torch_scan.py): an
    unknown remat policy raises; the vocab-sharded loss and an int8
    weight without its scale raise."""
    from paddle_tpu_torch import bridge
    from paddle_tpu_torch.core.enforce import EnforceError
    from paddle_tpu_torch.models.bert import BertConfig, BertForPretraining
    for over in (dict(scan_layers=True), dict(remat="full")):
        BertForPretraining(BertConfig(**dict(KW, **over)), device="cpu")
    with pytest.raises(EnforceError):
        BertForPretraining(BertConfig(**dict(KW, remat="most")),
                           device="cpu")
    m = BertForPretraining(BertConfig(**KW), device="cpu")
    ids = torch.zeros(1, 8, dtype=torch.long)
    with pytest.raises(NotImplementedError):
        m.loss(ids, ids[:, :2], ids[:, 0], torch.ones(1, 2),
               vocab_axis="tp")
    tree = bridge.export_params(m)
    tree["encoder"]["tok_emb"]["weight_q"] = np.zeros((300, 128), np.int8)
    with pytest.raises(KeyError):
        bridge.load_params(m, tree)


# ---------------------------------------------------------- optimizer

def test_bert_adam_three_steps_match_jax_from_bridged_state(rng):
    import paddle_tpu as pt
    from paddle_tpu_torch import bridge
    from paddle_tpu_torch.optimizer import Adam
    jm, params, pm = _pair()
    batch = _batch(rng)
    ids, ml, nl, mm, types, att, pos = batch
    lr = 1e-3
    jopt = pt.optimizer.Adam(lr)
    jstate = jopt.init(params)

    def jloss(p, *a):
        return jm.apply({"params": p, "state": {}}, *a, token_type_ids=types,
                        attention_mask=att, mask_positions=pos,
                        method="loss"), 0.0

    jargs = tuple(map(jnp.asarray, (ids, ml, nl, mm)))
    _, params, jstate, _ = jopt.minimize(jloss, params, jstate, *jargs)
    bridge.load_params(pm, _np_tree(params))
    popt = Adam(pm.parameters(), lr)
    bridge.load_opt_state(popt, pm, _np_tree(jstate))

    def ploss(m, *a):
        return m.loss(*a, token_type_ids=t(types), attention_mask=t(att),
                      mask_positions=t(pos))

    steps = 3
    for _ in range(steps):
        jl, params, jstate, _ = jopt.minimize(jloss, params, jstate, *jargs)
        pl = popt.minimize(pm, ploss, *map(t, (ids, ml, nl, mm)))
        np.testing.assert_allclose(float(pl), float(jl), **TOL)
    want = _flat(params)
    for name, p in pm.named_parameters():
        np.testing.assert_allclose(n(p), want[name], rtol=0,
                                   atol=2 * lr * steps, err_msg=name)
    assert int(bridge.export_opt_state(popt, pm)["step"]) == 1 + steps


def test_bert_bf16_policy_step_matches_jax_amp(rng):
    """One step under amp.decorate(Adam, bf16_policy()): the float inputs
    (mlm_mask) are cast to bf16 on both sides, as the reference casts its
    positional args."""
    import paddle_tpu as pt
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.optimizer import Adam
    jm, params, pm = _pair()
    ids, ml, nl, mm, types, att, pos = _batch(rng)
    policy = pt.amp.bf16_policy()

    def jloss(p, *a):
        return jm.apply({"params": p, "state": {}}, *a, token_type_ids=types,
                        attention_mask=att, mask_positions=pos,
                        method="loss")

    jargs = tuple(map(jnp.asarray, (ids, ml, nl, mm)))
    # the loss and gradient amp.decorate(...).minimize takes its step from
    jl, jg = jax.value_and_grad(lambda p: jloss(
        policy.cast_to_compute(p), *policy.cast_to_compute(jargs)).astype(
        jnp.float32))(params)
    popt = amp.decorate(Adam(pm.parameters(), 1e-3), amp.bf16_policy())
    pl = popt.minimize(pm, lambda m, *a: m.loss(
        *a, token_type_ids=t(types), attention_mask=t(att),
        mask_positions=t(pos)), *map(t, (ids, ml, nl, mm)))
    assert abs(float(pl) - float(jl)) <= 2e-2
    want = _flat(jg)
    got = {name: n(p.grad) for name, p in pm.named_parameters()}
    assert all(p.dtype == torch.float32 for p in pm.parameters())
    diff = sum(float(((got[k] - want[k].astype(np.float32)) ** 2).sum())
               for k in want)
    norm = sum(float((want[k].astype(np.float32) ** 2).sum()) for k in want)
    assert (diff / norm) ** 0.5 <= 5e-2


# --------------------------------------------------------------- ERNIE

@pytest.mark.parametrize("seed", [0, 1, 7])
def test_knowledge_mask_equals_jax(seed):
    from paddle_tpu.models.ernie import knowledge_mask as jax_km
    from paddle_tpu_torch.models.ernie import knowledge_mask
    rs = np.random.RandomState(seed + 100)
    ids = rs.randint(1, 512, (3, 48))
    ids[2, 40:] = 0                        # pads are never units
    spans = [[(2, 5), (10, 14), (30, 31)], [(0, 8), (47, 60)], []]
    for prob in (0.15, 0.5):
        got = knowledge_mask(ids, spans, mask_id=3, vocab_size=512,
                             mask_prob=prob, seed=seed)
        want = jax_km(ids, spans, mask_id=3, vocab_size=512, mask_prob=prob,
                      seed=seed)
        for g_, w_ in zip(got, want):
            np.testing.assert_array_equal(g_, w_)


def test_ernie_loss_matches_jax(rng):
    from paddle_tpu_torch.models.ernie import knowledge_mask
    jm, params, pm = _pair("ernie")
    assert pm.cfg.vocab_size == 300 and type(pm.cfg).__name__ == "ErnieConfig"
    ids, _, nl, _, types, att, _ = _batch(rng)
    masked, labels, weights = knowledge_mask(ids, [[(3, 6)], [(10, 13)]],
                                             mask_id=1, vocab_size=300,
                                             mask_prob=0.3, seed=2)
    batch = (masked.astype(np.int32), labels.astype(np.int32), nl, weights,
             types, att, None)
    jids, jl_, jnl, jw, jt, ja = map(jnp.asarray, batch[:6])
    want = jm.apply({"params": params, "state": {}}, jids, jl_, jnl, jw,
                    token_type_ids=jt, attention_mask=ja, method="loss")
    with torch.no_grad():
        got = pm.loss(*map(t, batch[:4]), token_type_ids=t(types),
                      attention_mask=t(att))
    np.testing.assert_allclose(float(got), float(want), **TOL)
