"""The port's one-device mixture of experts (``paddle_tpu_torch/nn/moe.py``
and ``GPTConfig.moe_experts``) against the JAX package's: the gating
cases of ``tests/test_moe.py``, the layer and its aux loss with their
gradients, a GPT whose FFNs are MoEs (logits, loss, gradients, greedy
generate, a few Adam steps), and the bf16 slot rounding both packages
share.

Tolerances: the gating's one-hots and positions exactly, its weights and
the layer 1e-5; model logits and loss 1e-4; gradients 1e-3 relative L2
per parameter; greedy tokens exactly.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

torch.set_num_threads(1)

OP_TOL = dict(rtol=1e-5, atol=1e-5)
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _tree(t):
    return jax.tree_util.tree_map(np.asarray, t)


def _gate_both(logits, k, capacity, jdt=jnp.float32, pdt=torch.float32):
    from paddle_tpu.nn.moe import top_k_gating as jgate
    from paddle_tpu_torch.nn.moe import top_k_gating
    want = jgate(jnp.asarray(logits, jdt), k, capacity)
    got = top_k_gating(torch.from_numpy(np.asarray(logits, np.float32))
                       .to(pdt), k, capacity)
    return got, want


GATING = {
    "topk": (np.asarray([[5.0, 0.0, 0.0], [5.0, 1.0, 0.0],
                         [0.0, 5.0, 0.0]], np.float32), 1, 2),
    "overflow": (np.asarray([[5.0, 0.0]] * 3, np.float32), 1, 2),
    "second_choice": (np.asarray([[5.0, 1.0], [1.0, 5.0]], np.float32), 2,
                      2),
    "balanced": (np.random.RandomState(0).randn(512, 8).astype(np.float32)
                 * 0.01, 1, 128),
    "top2_tight": (np.random.RandomState(1).randn(64, 4).astype(np.float32),
                   2, 20),
}


@pytest.mark.parametrize("case", sorted(GATING))
def test_top_k_gating_matches_jax(case):
    logits, k, cap = GATING[case]
    (d, c, aux), (jd, jc, jaux) = _gate_both(logits, k, cap)
    np.testing.assert_array_equal(_np(d), np.asarray(jd))
    np.testing.assert_allclose(_np(c), np.asarray(jc), **OP_TOL)
    np.testing.assert_allclose(float(aux), float(jaux), **OP_TOL)
    d = _np(d)
    if case == "topk":     # tokens 0, 1 -> expert 0 at 0, 1; token 2 -> 1
        assert d[0, 0, 0] == 1 and d[1, 0, 1] == 1 and d[2, 1, 0] == 1
    elif case == "overflow":          # the third token is dropped
        assert d[2].sum() == 0 and float(c[2].sum()) == 0
    elif case == "second_choice":     # second choices pack after first
        assert d[0, 0, 0] == 1 and d[1, 0, 1] == 1
        assert d[1, 1, 0] == 1 and d[0, 1, 1] == 1
    elif case == "balanced":
        assert 0.9 < float(aux) < 1.2


def test_bf16_slots_round_in_both_packages():
    """Under bf16 the slot cumsum rounds past 256, so tokens share a slot:
    the same tokens in both packages (a defect of both, kept)."""
    logits = np.zeros((600, 2), np.float32)
    logits[:, 0] = 5.0                       # every token to expert 0
    (d, _, _), (jd, _, _) = _gate_both(logits, 1, 600, jnp.bfloat16,
                                       torch.bfloat16)
    np.testing.assert_array_equal(_np(d), np.asarray(jd, np.float32))
    per_slot = _np(d)[:, 0, :].sum(0)
    # the 257th token's cumsum rounds to 256: slot 255 is taken twice
    assert per_slot[:255].max() == 1 and per_slot[255] == 2


def _layer_pair(seed=0, **kw):
    from paddle_tpu.nn.moe import MoE as JMoE
    from paddle_tpu_torch import bridge
    from paddle_tpu_torch.nn import MoE
    kw = dict(dim=8, hidden=16, num_experts=4, **kw)
    jl = JMoE(**kw)
    v = jl.init(jax.random.key(seed))
    pl = MoE(**kw)
    bridge.load_params(pl, _tree(v["params"]))
    return jl, v, pl


def test_moe_layer_matches_jax_and_per_token_ffn(rng):
    """Ample capacity, k = 1: ``y[t] = p * FFN_argmax(x[t])`` with the
    tanh-approximate gelu, and the JAX layer's output."""
    jl, v, pl = _layer_pair(k=1, capacity_factor=4.0)
    x = rng.randn(2, 4, 8).astype(np.float32)
    want = np.asarray(jl.apply(v, jnp.asarray(x)))
    with torch.no_grad():
        got = _np(pl(torch.from_numpy(x)))
    np.testing.assert_allclose(got, want, **OP_TOL)
    p = {n: t.detach().numpy() for n, t in pl.named_parameters()}
    xf = x.reshape(8, 8)
    logits = xf @ p["w_gate"]
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    probs /= probs.sum(-1, keepdims=True)
    ref = np.zeros_like(xf)
    for t in range(8):
        e = int(np.argmax(logits[t]))
        h = xf[t] @ p["w1"][e] + p["b1"][e]
        h = 0.5 * h * (1 + np.tanh(np.sqrt(2 / np.pi)
                                   * (h + 0.044715 * h ** 3)))
        ref[t] = probs[t, e] * (h @ p["w2"][e] + p["b2"][e])
    np.testing.assert_allclose(got.reshape(8, 8), ref, rtol=2e-4, atol=2e-5)


def test_moe_aux_loss_and_gradients_match_jax(rng):
    jl, v, pl = _layer_pair(seed=2, k=2)
    x = rng.randn(1, 16, 8).astype(np.float32)

    def jloss(params, xx):
        y, aux = jl.apply({"params": params, "state": {}}, xx,
                          method="forward_with_aux")
        return jnp.sum(y ** 2) + 0.01 * aux
    jv, (jg, jgx) = jax.value_and_grad(jloss, argnums=(0, 1))(
        v["params"], jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    y, aux = pl.forward_with_aux(xt)
    loss = (y ** 2).sum() + 0.01 * aux
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jv), **OP_TOL)
    np.testing.assert_allclose(_np(xt.grad), np.asarray(jgx), **OP_TOL)
    for name, prm in pl.named_parameters():
        np.testing.assert_allclose(_np(prm.grad), np.asarray(jg[name]),
                                   **OP_TOL)
    assert float(pl.w_gate.grad.abs().sum()) > 0


def test_moe_refuses_expert_parallelism():
    from paddle_tpu_torch.models.gpt import GPT, GPTConfig
    from paddle_tpu_torch.nn import MoE
    with pytest.raises(NotImplementedError):
        MoE(8, 16, 4, ep_axis="ep")
    cfg = GPTConfig.tiny()
    cfg.moe_experts, cfg.moe_ep_axis = 4, "ep"
    with pytest.raises(NotImplementedError):
        GPT(cfg, device="cpu")


KW = dict(vocab_size=128, hidden_size=32, num_layers=2, num_heads=2,
          intermediate_size=64, max_position=32, dropout=0.0,
          use_flash=False, moe_experts=4, moe_k=2)


def _gpt_pair(seed=0, decoder=False, **over):
    from paddle_tpu.models import gpt as J
    from paddle_tpu_torch import bridge
    from paddle_tpu_torch.models import gpt as P
    kw = dict(KW, **over)
    jm = (J.GPTDecoder if decoder else J.GPT)(J.GPTConfig(**kw))
    params = jm.init(jax.random.key(seed))["params"]
    pm = (P.GPTDecoder if decoder else P.GPT)(P.GPTConfig(**kw),
                                              device="cpu", seed=seed + 3)
    bridge.load_params(pm, _tree(params))
    return jm, params, pm


def _flat(tree):
    from paddle_tpu_torch import bridge
    return bridge.flatten(_tree(tree))


@pytest.mark.parametrize("use_flash", [False, True])
def test_gpt_moe_logits_loss_and_grads_match_jax(rng, use_flash):
    jm, params, pm = _gpt_pair(seed=1, use_flash=use_flash)
    assert "mlp" in params["blocks"]["0"]
    assert not hasattr(pm.blocks[0], "fc1")
    ids = rng.randint(0, 128, (2, 16)).astype(np.int32)
    ref = np.asarray(jm.apply({"params": params, "state": {}},
                              jnp.asarray(ids)))
    with torch.no_grad():
        np.testing.assert_allclose(_np(pm(torch.from_numpy(ids))), ref,
                                   **LOGIT_TOL)
    jl, jg = jax.value_and_grad(lambda p: jm.apply(
        {"params": p, "state": {}}, jnp.asarray(ids), method="loss"))(params)
    loss = pm.loss(torch.from_numpy(ids))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jl), **LOGIT_TOL)
    want = _flat(jg)
    # a gradient that is 0 in exact arithmetic (the key bias, which the
    # softmax cancels) is rounding noise: its error is taken relative to
    # 1e-3 of the largest gradient, as chip_smoke.train_crosscheck does
    top = max(np.linalg.norm(w) for w in want.values())
    for name, prm in pm.named_parameters():
        g, w = _np(prm.grad), want[name]
        err = np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-3 * top)
        assert err < 1e-3, (name, err)


def test_gpt_moe_generate_token_exact_vs_jax(rng):
    jm, params, pm = _gpt_pair(seed=2, decoder=True)
    prompt = rng.randint(0, 128, (3, 6)).astype(np.int32)
    want = np.asarray(jm.apply({"params": params, "state": {}},
                               jnp.asarray(prompt), 10, method="generate"))
    got = pm.generate(torch.from_numpy(prompt), 10)
    np.testing.assert_array_equal(got.numpy(), want)


def test_gpt_moe_trains(rng):
    """Eight Adam steps of the MoE GPT lower the loss (the reference's
    test_gpt_with_moe_ffn_trains)."""
    from paddle_tpu_torch.models.gpt import GPT, GPTConfig
    from paddle_tpu_torch.optimizer import Adam
    model = GPT(GPTConfig(**KW), device="cpu", seed=0)
    opt = Adam(model.parameters(), 1e-2)
    ids = torch.from_numpy(rng.randint(0, 128, (2, 16)).astype(np.int32))
    first = float(opt.minimize(model, lambda m, x: m.loss(x), ids))
    for _ in range(8):
        last = float(opt.minimize(model, lambda m, x: m.loss(x), ids))
    assert last < first
