"""The port's quantization (``paddle_tpu_torch/quant``) against the JAX
package's: every ``quant/ops.py`` function (``quantize_to_int`` bit for
bit, the straight-through gradient), ``quantize_weights_int8`` on the
same weights bit for bit, and int8 GPT, BERT and Transformer models
(the bridge carrying the JAX package's int8 tree), their decoding and
the serving engine with int8 weights.

Tolerances: f32 ops 1e-5; whole-model logits and losses 1e-4 (the f32
sums of two libraries in other orders); greedy tokens exactly.
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


# ------------------------------------------------------------------ ops

@pytest.mark.parametrize("axis", [None, 0, 1])
@pytest.mark.parametrize("bits", [8, 4, 16])
def test_quantize_to_int_is_bit_equal(rng, axis, bits):
    from paddle_tpu.quant import ops as JQ
    from paddle_tpu_torch.quant import ops as Q
    x = (rng.randn(37, 24) * rng.uniform(0.1, 3, 24)).astype(np.float32)
    x[3, :] = 0.0                                    # a zero row and column
    x[:, 5] = 0.0
    js = JQ.abs_max_scale(jnp.asarray(x), axis)
    ps = Q.abs_max_scale(torch.from_numpy(x), axis)
    np.testing.assert_array_equal(_np(ps), np.asarray(js))
    jq = np.asarray(JQ.quantize_to_int(jnp.asarray(x), js, bits, axis))
    pq = Q.quantize_to_int(torch.from_numpy(x), ps, bits, axis)
    assert pq.dtype == (torch.int8 if bits <= 8 else torch.int32)
    np.testing.assert_array_equal(pq.numpy(), jq)
    assert Q.qrange(bits) == JQ.qrange(bits)
    np.testing.assert_allclose(
        _np(Q.dequantize_from_int(pq, ps, bits, axis)),
        np.asarray(JQ.dequantize_from_int(jq, js, bits, axis)), **OP_TOL)


@pytest.mark.parametrize("axis", [None, 1])
def test_fake_quant_value_and_straight_through_gradient(rng, axis):
    """Forward values and the saturating STE: the gradient passes where
    |x| <= scale, 0 past it, and the scale takes a zero gradient."""
    from paddle_tpu.quant import ops as JQ
    from paddle_tpu_torch.quant import ops as Q
    x = rng.randn(16, 8).astype(np.float32) * 2
    scale = (np.full(8, 1.5, np.float32) if axis == 1
             else np.float32(1.5))
    dy = rng.randn(16, 8).astype(np.float32)

    def jf(xx, ss):
        return jnp.sum(JQ.fake_quant_dequant(xx, ss, 8, axis) * dy)
    jy = JQ.fake_quant_dequant(jnp.asarray(x), jnp.asarray(scale), 8, axis)
    jgx, jgs = jax.grad(jf, argnums=(0, 1))(jnp.asarray(x),
                                            jnp.asarray(scale))
    xt = torch.from_numpy(x).requires_grad_()
    st = torch.tensor(scale).requires_grad_()
    y = Q.fake_quant_dequant(xt, st, 8, axis)
    (y * torch.from_numpy(dy)).sum().backward()
    np.testing.assert_allclose(_np(y), np.asarray(jy), **OP_TOL)
    np.testing.assert_array_equal(_np(xt.grad), np.asarray(jgx))
    np.testing.assert_array_equal(_np(st.grad), np.asarray(jgs))
    assert (xt.grad.abs() > 0).sum() < x.size     # some entries saturate

    jg = jax.grad(lambda xx: jnp.sum(JQ.fake_quant_abs_max(xx, 8, axis)
                                     * dy))(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    y = Q.fake_quant_abs_max(xt, 8, axis)
    (y * torch.from_numpy(dy)).sum().backward()
    np.testing.assert_allclose(
        _np(y), np.asarray(JQ.fake_quant_abs_max(jnp.asarray(x), 8, axis)),
        **OP_TOL)
    np.testing.assert_array_equal(_np(xt.grad), np.asarray(jg))


def test_running_scales_match_jax(rng):
    from paddle_tpu.quant import ops as JQ
    from paddle_tpu_torch.quant import ops as Q
    x = rng.randn(32, 4).astype(np.float32)
    np.testing.assert_allclose(
        _np(Q.moving_average_scale(0.7, torch.from_numpy(x), 0.9)),
        np.asarray(JQ.moving_average_scale(0.7, jnp.asarray(x), 0.9)),
        **OP_TOL)
    for step in (0, 3, 20, 21):
        for prev in (0.1, 9.0):
            np.testing.assert_allclose(
                _np(Q.range_abs_max_scale(prev, torch.from_numpy(x), step,
                                          window_size=10)),
                np.asarray(JQ.range_abs_max_scale(prev, jnp.asarray(x),
                                                  step, window_size=10)),
                **OP_TOL)


# ------------------------------------------------------- weight-only int8

def _gpt_pair(seed=0, **over):
    """(jax model, jax params, port GPTDecoder) with the same weights."""
    from paddle_tpu.models.gpt import GPTConfig, GPTDecoder
    from paddle_tpu_torch import bridge
    from paddle_tpu_torch.models.gpt import GPTConfig as PConfig
    from paddle_tpu_torch.models.gpt import GPTDecoder as PDecoder
    kw = dict(dropout=0.0, **over)
    jm = GPTDecoder(GPTConfig(**{**GPTConfig.tiny().__dict__, **kw}))
    params = _tree(jm.init(jax.random.key(seed))["params"])
    pm = PDecoder(PConfig(**{**PConfig.tiny().__dict__, **kw}),
                  device="cpu", seed=seed + 50).eval()
    bridge.load_params(pm, params)
    return jm, params, pm


def test_quantize_weights_int8_is_bit_equal_to_jax():
    """The same weights through both transforms: the same leaves, the
    int8 values and scales bit for bit, 2L + 4L + 2 int8 leaves (every
    FFN Linear, the four attention projections of each block, both
    embeddings)."""
    from paddle_tpu import quant as jquant
    from paddle_tpu_torch import bridge
    from paddle_tpu_torch.quant import quantize_weights_int8
    jm, params, pm = _gpt_pair()
    want = bridge.flatten(_tree(jquant.quantize_weights_int8(jm, params)))
    quantize_weights_int8(pm)
    got = bridge.flatten(bridge.export_params(pm))
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k])
    layers = pm.cfg.num_layers
    n8 = sum(p.dtype == torch.int8 for p in pm.parameters())
    assert n8 == 2 * layers + 4 * layers + 2
    assert all(not p.requires_grad for n, p in pm.named_parameters()
               if n.endswith(("_q", "_scale")))
    assert pm.blocks[0].fc1.weight_scale.dtype == torch.float32


def test_min_size_and_exact_type_targeting():
    from paddle_tpu_torch import nn as pnn
    from paddle_tpu_torch.quant import quantize_weights_int8

    class Sub(pnn.Linear):
        pass

    small = torch.nn.ModuleDict({"a": pnn.Linear(4, 4), "b": Sub(64, 128),
                                 "c": pnn.Linear(64, 128),
                                 "e": pnn.Embedding(128, 64)})
    quantize_weights_int8(small)
    names = dict(small.named_parameters())
    assert "a.weight" in names and "a.weight_q" not in names   # < 4096
    assert "b.weight" in names                                  # subclass
    assert names["c.weight_q"].dtype == torch.int8
    assert names["e.weight_q"].dtype == torch.int8
    small = torch.nn.ModuleDict({"e": pnn.Embedding(128, 64)})
    quantize_weights_int8(small, include_embeddings=False)
    assert "e.weight" in dict(small.named_parameters())


def test_int8_layers_match_jax(rng):
    """Linear (the exact dequant identity), an Embedding with a padding
    index, and a bf16 Embedding that stays bf16, each quantized by both
    packages from the same weights."""
    from paddle_tpu import quant as jquant
    from paddle_tpu.nn import layers as JL
    from paddle_tpu_torch import bridge
    from paddle_tpu_torch import nn as pnn
    from paddle_tpu_torch.quant import quantize_weights_int8
    x = rng.randn(4, 3, 32).astype(np.float32)
    cases = [(JL.Linear(32, 16), pnn.Linear(32, 16), x, jnp.float32),
             (JL.Embedding(64, 8, padding_idx=0),
              pnn.Embedding(64, 8, padding_idx=0),
              np.asarray([[0, 3, 0, 5], [7, 0, 1, 63]], np.int32),
              jnp.float32),
             (JL.Embedding(64, 8), pnn.Embedding(64, 8),
              np.asarray([[1], [2]], np.int32), jnp.bfloat16)]
    for jl, pl, inp, dt in cases:
        v = jl.init(jax.random.key(0), dtype=dt)
        qp = jquant.quantize_weights_int8(jl, v["params"], min_size=1)
        ref = jl.apply({"params": qp, "state": {}}, jnp.asarray(inp))
        if dt == jnp.bfloat16:
            pl = pl.to(torch.bfloat16)
        bridge.load_params(pl, _tree(qp))
        got = pl(torch.from_numpy(inp))
        quantize_weights_int8(pl)                   # already int8: a no-op
        assert str(got.dtype).split(".")[-1] == str(ref.dtype)
        np.testing.assert_allclose(_np(got), np.asarray(ref, np.float32),
                                   **OP_TOL)
    p2 = pnn.Linear(32, 16, gen=torch.Generator().manual_seed(0))
    w = p2.weight.detach().clone()
    quantize_weights_int8(p2, min_size=1)
    wd = p2.weight_q.float() * p2.weight_scale[None, :]
    step = w.abs().amax(0) / 127.0
    assert bool(((wd - w).abs() <= step[None, :] * 0.5 + 1e-7).all())
    xt = torch.from_numpy(x)
    np.testing.assert_allclose(_np(p2(xt)), _np(xt @ wd + p2.bias),
                               **OP_TOL)


def test_int8_gpt_logits_loss_and_decode_match_jax(rng):
    """A float port model takes the JAX package's int8 tree through the
    bridge: the full forward, the loss (lm_loss of the logits over an
    int8 table), a decode step's logits and caches, and greedy generate
    agree with the JAX model on the same tree; the port's own
    quantization of the float weights gives the same model."""
    from paddle_tpu import quant as jquant
    from paddle_tpu.models.gpt import lm_loss as jlm
    from paddle_tpu_torch import bridge
    from paddle_tpu_torch.models.gpt import GPTConfig, GPTDecoder
    jm, params, pm = _gpt_pair(seed=1)
    qp = _tree(jquant.quantize_weights_int8(jm, params))
    jv = {"params": qp, "state": {}}
    bridge.load_params(pm, qp)
    assert pm.tok_emb.weight_q.dtype == torch.int8
    ids = rng.randint(0, 512, (2, 12)).astype(np.int32)
    ref = np.asarray(jm.apply(jv, jnp.asarray(ids)))
    with torch.no_grad():
        np.testing.assert_allclose(_np(pm(torch.from_numpy(ids))), ref,
                                   **LOGIT_TOL)
        np.testing.assert_allclose(
            float(pm.loss(torch.from_numpy(ids))),
            float(jlm(jnp.asarray(ref), jnp.asarray(ids))), **LOGIT_TOL)
    jt = np.asarray(jm.apply(jv, jnp.asarray(ids[:, :5]), 6,
                             method="generate"))
    pt_ = pm.generate(torch.from_numpy(ids[:, :5]), 6)
    np.testing.assert_array_equal(pt_.numpy(), jt)
    # the int8 model exports the tree it loaded; a float model of another
    # seed quantized by the port equals it after loading the float tree
    back = bridge.flatten(bridge.export_params(pm))
    for k, val in bridge.flatten(qp).items():
        np.testing.assert_array_equal(back[k], val)
    cfg = GPTConfig.tiny()
    cfg.dropout = 0.0
    other = GPTDecoder(cfg, device="cpu", seed=7)
    bridge.load_params(other, params)
    from paddle_tpu_torch.quant import quantize_weights_int8
    quantize_weights_int8(other)
    fresh = GPTDecoder(cfg, device="cpu", seed=9)
    bridge.load_params(fresh, bridge.export_params(other))
    with torch.no_grad():
        np.testing.assert_array_equal(
            _np(fresh(torch.from_numpy(ids))),
            _np(other(torch.from_numpy(ids))))


def test_bridge_refuses_a_broken_int8_tree():
    from paddle_tpu_torch import bridge
    _, params, pm = _gpt_pair()
    bad = bridge.flatten(params)
    bad["tok_emb.weight_q"] = np.zeros((512, 64), np.int8)   # no scale
    with pytest.raises(KeyError):
        bridge.load_params(pm, bridge._nest(bad.items()))
    bad["tok_emb.weight_scale"] = np.zeros(512, np.float32)   # and weight
    with pytest.raises(KeyError):
        bridge.load_params(pm, bridge._nest(bad.items()))
    _, params, pm = _gpt_pair()
    bad = bridge.flatten(params)
    w = bad.pop("tok_emb.weight")
    bad["tok_emb.weight_q"] = np.zeros((w.shape[0] + 1, w.shape[1]),
                                       np.int8)
    bad["tok_emb.weight_scale"] = np.zeros(w.shape[0] + 1, np.float32)
    with pytest.raises(ValueError):
        bridge.load_params(pm, bridge._nest(bad.items()))


def test_int8_bert_logits_and_loss_match_jax(rng):
    """BERT's tied MLM head over an int8 table: logits and the loss
    (pretrain_loss of the logits, as the reference switches to)."""
    from paddle_tpu import quant as jquant
    from paddle_tpu.models.bert import BertConfig as JC
    from paddle_tpu.models.bert import BertForPretraining as JM
    from paddle_tpu_torch import bridge
    from paddle_tpu_torch.models.bert import BertConfig, BertForPretraining
    kw = dict(vocab_size=128, hidden_size=64, num_layers=1, num_heads=2,
              intermediate_size=128, max_position=64, dropout=0.0)
    jm = JM(JC(**kw))
    qp = _tree(jquant.quantize_weights_int8(
        jm, jm.init(jax.random.key(0))["params"], min_size=16))
    pm = BertForPretraining(BertConfig(**kw), device="cpu", seed=3).eval()
    bridge.load_params(pm, qp)
    ids = rng.randint(0, 128, (2, 16)).astype(np.int32)
    pos = np.stack([np.sort(rng.choice(16, 3, replace=False))
                    for _ in range(2)]).astype(np.int32)
    labels = rng.randint(0, 128, (2, 3)).astype(np.int32)
    nsp = np.asarray([0, 1], np.int32)
    mask = np.ones((2, 3), np.float32)
    jv = {"params": qp, "state": {}}
    jl, jn = jm.apply(jv, jnp.asarray(ids), mask_positions=jnp.asarray(pos))
    jloss = jm.apply(jv, jnp.asarray(ids), jnp.asarray(labels),
                     jnp.asarray(nsp), jnp.asarray(mask),
                     mask_positions=jnp.asarray(pos), method="loss")
    t = torch.from_numpy
    with torch.no_grad():
        pl, pn = pm(t(ids), mask_positions=t(pos))
        ploss = pm.loss(t(ids), t(labels), t(nsp), t(mask),
                        mask_positions=t(pos))
    np.testing.assert_allclose(_np(pl), np.asarray(jl), **LOGIT_TOL)
    np.testing.assert_allclose(_np(pn), np.asarray(jn), **LOGIT_TOL)
    np.testing.assert_allclose(float(ploss), float(jloss), **LOGIT_TOL)


def test_int8_transformer_logits_and_loss_match_jax(rng):
    """The Transformer with int8 projections, attention kernels and
    out_proj: logits and the loss (nmt_loss of the logits)."""
    from paddle_tpu import quant as jquant
    from paddle_tpu.models.transformer import Transformer as JM
    from paddle_tpu.models.transformer import TransformerConfig as JC
    from paddle_tpu_torch import bridge
    from paddle_tpu_torch.models.transformer import (Transformer,
                                                     TransformerConfig)
    jc = JC.tiny()
    jc.dropout = 0.0
    jm = JM(jc)
    qp = _tree(jquant.quantize_weights_int8(
        jm, jm.init(jax.random.key(0))["params"], min_size=16))
    pc = TransformerConfig.tiny()
    pc.dropout = 0.0
    pm = Transformer(pc, device="cpu", seed=2).eval()
    bridge.load_params(pm, qp)
    assert pm.out_proj.weight_q.dtype == torch.int8
    src = rng.randint(1, jc.src_vocab, (2, 9)).astype(np.int32)
    tgt = rng.randint(1, jc.tgt_vocab, (2, 7)).astype(np.int32)
    out = rng.randint(0, jc.tgt_vocab, (2, 7)).astype(np.int32)
    smask = np.ones((2, 9), np.float32)
    smask[1, 6:] = 0
    jv = {"params": qp, "state": {}}
    ref = jm.apply(jv, jnp.asarray(src), jnp.asarray(tgt),
                   jnp.asarray(smask))
    jloss = jm.apply(jv, jnp.asarray(src), jnp.asarray(tgt),
                     jnp.asarray(out), jnp.asarray(smask), method="loss")
    t = torch.from_numpy
    with torch.no_grad():
        got = pm(t(src), t(tgt), t(smask))
        ploss = pm.loss(t(src), t(tgt), t(out), t(smask))
    np.testing.assert_allclose(_np(got), np.asarray(ref), **LOGIT_TOL)
    np.testing.assert_allclose(float(ploss), float(jloss), **LOGIT_TOL)


SPECS = [(5, 6), (11, 9), (3, 4), (8, 7), (16, 5), (27, 4)]


def test_int8_engine_token_exact_vs_jax_engine_and_generate(rng):
    """The serving engine over int8 weights: every request's greedy
    tokens equal the JAX ServingEngine's on the same int8 tree, and the
    port's own generate on the same prompt (the gold test)."""
    from paddle_tpu import quant as jquant
    from paddle_tpu.serving import ServeConfig as JServe
    from paddle_tpu.serving import ServingEngine as JEngine
    from paddle_tpu_torch import bridge
    from paddle_tpu_torch.serving import ServeConfig, ServingEngine
    jm, params, pm = _gpt_pair(seed=2)
    qp = _tree(jquant.quantize_weights_int8(jm, params))
    bridge.load_params(pm, qp)
    kw = dict(num_slots=2, page_size=8, max_len=40, prefill_len=16,
              prefix_cache=False)
    je = JEngine(jm, {"params": qp, "state": {}}, JServe(**kw))
    pe = ServingEngine(pm, ServeConfig(**kw))
    prompts = [rng.randint(0, 512, (n,)).astype(np.int32) for n, _ in SPECS]
    for p, (_, mn) in zip(prompts, SPECS):
        je.submit(p, max_new=mn)
        pe.submit(p, max_new=mn)
    want = {r.id: r.output for r in je.drain()}
    got = {r.id: r for r in pe.drain()}
    assert sorted(got) == sorted(want)
    for i, (rid, req) in enumerate(sorted(got.items())):
        np.testing.assert_array_equal(req.output, want[rid])
        gen = pm.generate(torch.from_numpy(prompts[i])[None], SPECS[i][1])
        np.testing.assert_array_equal(gen[0, len(prompts[i]):].numpy(),
                                      np.asarray(req.tokens))


@pytest.mark.parametrize("case", ["float", "int8_fc1", "act_fc2"])
def test_fused_ffn_dispatch_matches_jax(rng, case):
    """``fused_ffn`` keeps the reference's dispatch: the fused MLP for two
    plain float layers, the unfused ``fc2(gelu(fc1(x)))`` when a layer is
    int8 or carries its own activation (which is then applied too)."""
    from paddle_tpu import quant as jquant
    from paddle_tpu.nn import layers as JL
    from paddle_tpu_torch import bridge
    from paddle_tpu_torch import nn as pnn
    act2 = "relu" if case == "act_fc2" else None
    j1, j2 = JL.Linear(16, 64), JL.Linear(64, 16, act=act2)
    v1, v2 = j1.init(jax.random.key(0)), j2.init(jax.random.key(1))
    p1, p2 = pnn.Linear(16, 64), pnn.Linear(64, 16, act=act2)
    if case == "int8_fc1":
        v1 = {"params": jquant.quantize_weights_int8(j1, v1["params"],
                                                     min_size=1)}
    bridge.load_params(p1, _tree(v1["params"]))
    bridge.load_params(p2, _tree(v2["params"]))
    x = rng.randn(3, 5, 16).astype(np.float32)
    want = _jax_ffn(j1, v1, j2, v2, x)
    with torch.no_grad():
        got = pnn.fused_ffn(p1, p2, torch.from_numpy(x))
    np.testing.assert_allclose(_np(got), want, **OP_TOL)
    if act2:
        assert float(got.min()) >= 0.0


def _jax_ffn(j1, v1, j2, v2, x):
    """The JAX package's ``fused_ffn`` of the two layers (applied inside a
    wrapper module, as models call it)."""
    from paddle_tpu.nn import layers as JL
    from paddle_tpu.nn.module import Module

    class Pair(Module):
        def __init__(self):
            super().__init__()
            self.fc1, self.fc2 = j1, j2

        def forward(self, xx):
            return JL.fused_ffn(self.fc1, self.fc2, xx)
    params = {"fc1": v1["params"], "fc2": v2["params"]}
    return np.asarray(Pair().apply({"params": params, "state": {}},
                                   jnp.asarray(x)))
