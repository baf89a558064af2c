"""The port's KV-cache decoding (``MultiHeadAttention.init_cache`` /
``prefill`` / ``decode_step``, ``GPTDecoder.init_caches`` /
``decode_step`` / ``generate``) against the JAX package's, on
GPTConfig.tiny() with the weights carried over by the bridge; and the
port's serving engine against the port's own ``generate``.

Tolerances: an attention layer's outputs and caches 1e-5 (f32 ops);
whole-model logits 1e-4; one layer's bf16 cache entries one bf16 step
(2^-7 relative), and a model's logits and caches read through bf16
caches 2^-8 of their largest: the two libraries' f32 K/V differ in the
last bits, where that straddles a bf16 rounding boundary the stored
entries are one step apart, and the next layers see it; greedy tokens
exactly.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.core.flags import all_flags, set_flags

torch.set_num_threads(1)

OP_TOL = dict(rtol=1e-5, atol=1e-5)
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
BF16_TOL = dict(rtol=2 ** -7, atol=1e-5)
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture
def flags_guard():
    saved = all_flags()
    yield
    set_flags(saved)


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _pair(seed=0, use_flash=True):
    """(jax model, jax variables, port model) with identical weights."""
    from paddle_tpu.models.gpt import GPTConfig, GPTDecoder
    from paddle_tpu_torch import bridge
    from paddle_tpu_torch.models.gpt import GPTConfig as PConfig
    from paddle_tpu_torch.models.gpt import GPTDecoder as PDecoder
    cfg = GPTConfig.tiny()
    cfg.dropout = 0.0
    cfg.use_flash = use_flash
    jm = GPTDecoder(cfg)
    v = jm.init(jax.random.key(seed))
    pcfg = PConfig.tiny()
    pcfg.dropout = 0.0
    pcfg.use_flash = use_flash
    pm = PDecoder(pcfg, device="cpu", seed=seed + 100).eval()
    bridge.load_params(pm, jax.tree_util.tree_map(np.asarray, v["params"]))
    return jm, v, pm


def _jcall(jm, v, fn, *args):
    return jm.apply(v, jnp.zeros((1,)), method=lambda _: fn(*args))


@pytest.mark.parametrize("cache", ["f32", "bf16"])
@pytest.mark.parametrize("use_flash", [True, False])
def test_mha_prefill_and_decode_step_match_jax(rng, cache, use_flash):
    """One attention layer: a 6-token prefill into a cache of 10, then
    three decode steps; outputs and caches after every call."""
    from paddle_tpu.nn.layers import MultiHeadAttention as JMHA
    from paddle_tpu_torch import bridge
    from paddle_tpu_torch.nn import MultiHeadAttention
    jdt, pdt = DTYPES[cache]
    jl = JMHA(32, 4, use_flash=use_flash)
    v = jl.init(jax.random.key(1))
    pl = MultiHeadAttention(32, 4, use_flash=use_flash)
    bridge.load_params(pl, jax.tree_util.tree_map(np.asarray, v["params"]))
    x = rng.randn(2, 6, 32).astype(np.float32)
    jc = _jcall(jl, v, jl.init_cache, 2, 10, jdt)
    pc = pl.init_cache(2, 10, pdt)
    assert pc["k"].dtype == pdt and tuple(pc["k"].shape) == (2, 4, 10, 8)
    jo, jc = _jcall(jl, v, jl.prefill, jnp.asarray(x), jc)
    with torch.no_grad():
        po, pc = pl.prefill(torch.from_numpy(x), pc)
    tol = OP_TOL if cache == "f32" else BF16_TOL
    np.testing.assert_allclose(_np(po), np.asarray(jo), **OP_TOL)
    for pos in (6, 7, 8):
        xt = rng.randn(2, 1, 32).astype(np.float32)
        jo, jc = _jcall(jl, v, jl.decode_step, jnp.asarray(xt), jc, pos)
        with torch.no_grad():
            po, pc = pl.decode_step(torch.from_numpy(xt), pc, pos)
        assert po.dtype == torch.float32       # f32 query against the cache
        np.testing.assert_allclose(_np(po), np.asarray(jo, np.float32),
                                   **OP_TOL)
        for name in ("k", "v"):
            assert pc[name].dtype == pdt
            np.testing.assert_allclose(_np(pc[name]),
                                       np.asarray(jc[name], np.float32),
                                       **tol)
    with pytest.raises(NotImplementedError):
        pl.prefill(torch.from_numpy(x), pc, start=2)


@pytest.mark.parametrize("cache", ["f32", "bf16"])
def test_gpt_decode_step_logits_and_caches_match_jax(rng, cache):
    """GPTDecoder.decode_step from empty caches, token by token: each
    step's logits and every layer's cache."""
    jdt, pdt = DTYPES[cache]
    jm, v, pm = _pair(seed=2)
    toks = rng.randint(0, 512, (3, 7)).astype(np.int32)
    jc = _jcall(jm, v, jm.init_caches, 3, 12, jdt)
    pc = pm.init_caches(3, 12, pdt)
    tol = OP_TOL
    for pos in range(toks.shape[1]):
        tok = toks[:, pos:pos + 1]
        jl, jc = _jcall(jm, v, jm.decode_step, jnp.asarray(tok), jc, pos)
        with torch.no_grad():
            pl, pc = pm.decode_step(torch.from_numpy(tok), pc, pos)
        assert tuple(pl.shape) == (3, 1, 512)
        want = np.asarray(jl)
        np.testing.assert_allclose(
            _np(pl), want, **(LOGIT_TOL if cache == "f32" else dict(
                rtol=0, atol=2 ** -8 * np.abs(want).max())))
    for jlayer, player in zip(jc, pc):
        for name in ("k", "v"):
            want = np.asarray(jlayer[name], np.float32)
            if cache == "bf16":   # the flips above reach the next layer
                tol = dict(rtol=0, atol=2 ** -8 * np.abs(want).max())
            np.testing.assert_allclose(_np(player[name]), want, **tol)


@pytest.mark.parametrize("cache", ["f32", "bf16"])
@pytest.mark.parametrize("mode", ["flash", "interpret", "dense"])
def test_generate_greedy_token_exact_vs_jax(rng, flags_guard, cache, mode):
    """Greedy generate: the batched prefill (flash attention, or the
    dense path with use_flash off; ``interpret`` runs the JAX side's
    Pallas kernels in interpret mode), then the decode steps."""
    if mode == "interpret":
        set_flags({"pallas_interpret": True})
    jdt, pdt = DTYPES[cache]
    jm, v, pm = _pair(seed=3, use_flash=mode != "dense")
    prompt = rng.randint(0, 512, (3, 9)).astype(np.int32)
    want = np.asarray(jm.apply(v, jnp.asarray(prompt), 12,
                               cache_dtype=jdt, method="generate"))
    got = pm.generate(torch.from_numpy(prompt), 12, cache_dtype=pdt)
    assert got.dtype == torch.int32 and tuple(got.shape) == (3, 21)
    np.testing.assert_array_equal(got.numpy(), want)


def test_sampled_generate_is_fixed_by_its_generator(rng):
    from paddle_tpu_torch.core.enforce import EnforceError
    _, _, pm = _pair(seed=4)
    prompt = torch.from_numpy(rng.randint(0, 512, (2, 5)).astype(np.int32))

    def draw(seed):
        return pm.generate(prompt, 16, temperature=0.9,
                           generator=torch.Generator().manual_seed(seed))
    a, b, c = draw(11), draw(11), draw(12)
    assert torch.equal(a, b)
    assert not torch.equal(a, c)
    assert torch.equal(a[:, :5], prompt)
    assert bool(((a >= 0) & (a < 512)).all())
    greedy = pm.generate(prompt, 16)
    assert torch.equal(greedy, pm.generate(prompt, 16, temperature=0.0))
    with pytest.raises(EnforceError):
        pm.generate(prompt, 4, temperature=0.5)
    with pytest.raises(EnforceError):            # past max_position
        pm.generate(prompt, 128)


SPECS = [(5, 6), (11, 9), (3, 4), (8, 7), (16, 5), (2, 8), (27, 4)]


@pytest.mark.parametrize("cache", ["f32", "bf16"])
def test_engine_token_exact_vs_generate(rng, cache):
    """The gold test of the JAX engine on the port: every request of a
    wave through a 2-slot engine (one prompt longer than prefill_len)
    equals generate on its prompt alone, token for token."""
    from paddle_tpu_torch.serving import ServeConfig, ServingEngine
    _, _, pm = _pair(seed=5)
    pdt = DTYPES[cache][1]
    eng = ServingEngine(pm, ServeConfig(num_slots=2, page_size=8,
                                        max_len=40, prefill_len=16,
                                        cache_dtype=pdt))
    prompts = [rng.randint(0, 512, (n,)).astype(np.int32) for n, _ in SPECS]
    rids = [eng.submit(p, max_new=mn) for p, (_, mn) in zip(prompts, SPECS)]
    done = {r.id: r for r in eng.drain()}
    for rid, p, (_, mn) in zip(rids, prompts, SPECS):
        gen = pm.generate(torch.from_numpy(p)[None], mn, cache_dtype=pdt)
        assert list(gen[0, len(p):].numpy()) == list(done[rid].tokens), rid
