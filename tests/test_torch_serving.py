"""The PyTorch port's model and serving engine against the JAX reference,
on GPTConfig.tiny() with the weights carried over by the bridge.

Whole-model logits are held to 1e-4 (not the per-op 1e-5): two layers of
f32 matmuls whose sums XLA and PyTorch's CPU kernels take in different
orders, plus the vocab head, compound the per-op rounding differences.
The engine's greedy tokens must match the JAX ServingEngine exactly.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.core.flags import all_flags, set_flags

torch.set_num_threads(1)

LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture
def flags_guard():
    saved = all_flags()
    yield
    set_flags(saved)


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


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


# ------------------------------------------------------------------ bridge

def test_bridge_round_trip_and_refusals():
    from paddle_tpu_torch import bridge
    jm, v, pm = _pair()
    tree = jax.tree_util.tree_map(np.asarray, v["params"])
    back = bridge.flatten(bridge.export_params(pm))
    want = bridge.flatten(tree)
    assert sorted(back) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(back[k], want[k])
    assert pm.blocks[0].attn.wq.shape == tuple(
        tree["blocks"]["0"]["attn"]["wq"].shape)    # [in, out]: no transpose
    # an int8 weight must come with its scale (int8 trees load since the
    # port has weight-only int8)
    bad = dict(tree, tok_emb={"weight_q": tree["tok_emb"]["weight"]})
    with pytest.raises(KeyError):
        bridge.load_params(pm, bad)
    missing = {k: val for k, val in tree.items() if k != "ln_f"}
    with pytest.raises(KeyError):
        bridge.load_params(pm, missing)


# ------------------------------------------------------------ full forward

@pytest.mark.parametrize("use_flash", [True, False])
def test_gpt_forward_logits_match_jax(rng, use_flash):
    jm, v, pm = _pair(use_flash=use_flash)
    ids = rng.randint(0, 512, (2, 20)).astype(np.int32)
    ref = np.asarray(jm.apply(v, jnp.asarray(ids)))
    with torch.no_grad():
        got = _np(pm(torch.from_numpy(ids)))
    np.testing.assert_allclose(got, ref, **LOGIT_TOL)


# ------------------------------------------------------ paged model methods

@pytest.mark.parametrize("mode", ["f32", "int8", "interpret"])
def test_paged_prefill_chunk_and_decode_match_jax(rng, flags_guard, mode):
    """The same pools, the same calls: a two-row whole-prompt prefill, a
    continuation chunk for row 0 (gathered-prefix attention), then decode
    steps with one slot going inactive. Logits and pools must agree.
    ``interpret`` runs the JAX side through its Pallas kernels in
    interpret mode."""
    jm, v, pm = _pair(seed=3)
    if mode == "interpret":
        set_flags({"pallas_interpret": True, "use_pallas_decode": True,
                   "use_pallas_mlp": True, "use_pallas_layer_norm": True})
    jkv = jnp.int8 if mode == "int8" else None
    pkv = torch.int8 if mode == "int8" else None
    n_pages, ps, lp = 12, 8, 16
    jc = jm.init_paged_caches(n_pages, ps, kv_dtype=jkv)
    pc = pm.init_paged_caches(n_pages, ps, kv_dtype=pkv)
    rows = np.asarray([[5, 2, 9, 0], [7, 1, 0, 0]], np.int32)
    prompt = rng.randint(0, 512, (2, lp)).astype(np.int32)

    def jcall(fn, *args):
        return jm.apply(v, jnp.zeros((1,)), method=lambda _: fn(*args))

    def check(jout, pout):
        np.testing.assert_allclose(_np(pout[0]), np.asarray(jout[0]),
                                   **LOGIT_TOL)
        for jp, pp in zip(jout[1], pout[1]):
            for name in jp:
                np.testing.assert_allclose(_np(pp[name]),
                                           np.asarray(jp[name], np.float32),
                                           rtol=1e-5, atol=1e-5)
        return jout[1]

    with torch.no_grad():
        # whole-prompt prefill of two requests (lengths 16 and 11)
        lens = np.asarray([16, 11], np.int32)
        jout = jcall(jm.paged_prefill, jnp.asarray(prompt),
                     jnp.asarray(lens), jc, jnp.asarray(rows))
        pout = pm.paged_prefill(torch.from_numpy(prompt),
                                torch.from_numpy(lens), pc,
                                torch.from_numpy(rows))
        jc = check(jout, pout)
        # continuation chunk of request 0: 9 more tokens at 16..24
        cont = np.zeros((1, lp), np.int32)
        cont[0, :9] = rng.randint(0, 512, 9)
        jout = jcall(jm.paged_prefill_chunk, jnp.asarray(cont),
                     jnp.asarray([16], jnp.int32),
                     jnp.asarray([9], jnp.int32), jc,
                     jnp.asarray(rows[:1]))
        pout = pm.paged_prefill_chunk(
            torch.from_numpy(cont), torch.tensor([16], dtype=torch.int32),
            torch.tensor([9], dtype=torch.int32), pc,
            torch.from_numpy(rows[:1]))
        jc = check(jout, pout)
        # decode steps; slot 1 goes inactive on the last one
        lengths = np.asarray([25, 11], np.int32)
        for step in range(3):
            toks = rng.randint(0, 512, 2).astype(np.int32)
            active = np.asarray([True, step < 2])
            jout = jcall(jm.paged_decode_step, jnp.asarray(toks), jc,
                         jnp.asarray(rows), jnp.asarray(lengths),
                         jnp.asarray(active))
            pout = pm.paged_decode_step(
                torch.from_numpy(toks), pc, torch.from_numpy(rows),
                torch.from_numpy(lengths), torch.from_numpy(active))
            assert pout[1] is pc                    # pools updated in place
            jc = check(jout, pout)
            lengths = lengths + active.astype(np.int32)


def test_mha_paged_prefill_matches_jax(rng):
    """The layer-level prompt fill: causal attention over the window and
    K/V scattered to (page, offset), pad positions dropped."""
    from paddle_tpu import nn as jnn
    from paddle_tpu_torch import bridge
    from paddle_tpu_torch.nn import MultiHeadAttention
    jl = jnn.MultiHeadAttention(32, 4)
    v = jl.init(jax.random.key(0))
    pl = MultiHeadAttention(32, 4)
    bridge.load_params(pl, jax.tree_util.tree_map(np.asarray, v["params"]))
    x = rng.randn(2, 8, 32).astype(np.float32)
    ids = np.asarray([[0] * 8, [1] * 5 + [3] * 3], np.int32)   # 3 = drop
    offs = np.asarray([list(range(8)), list(range(8))], np.int32)
    jpool = jl.init_page_pool(3, 8)
    jout, jpool = jl.apply(
        v, jnp.asarray(x), method=lambda xx: jl.paged_prefill(
            xx, jpool, jnp.asarray(ids), jnp.asarray(offs)))
    ppool = pl.init_page_pool(3, 8)
    with torch.no_grad():
        pout, _ = pl.paged_prefill(torch.from_numpy(x), ppool,
                                   torch.from_numpy(ids),
                                   torch.from_numpy(offs))
    np.testing.assert_allclose(_np(pout), np.asarray(jout), rtol=1e-5,
                               atol=1e-5)
    for name in jpool:
        np.testing.assert_allclose(_np(ppool[name]), np.asarray(jpool[name]),
                                   rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------------ engine

SPECS = [(5, 6), (11, 9), (3, 4), (8, 7), (16, 5), (2, 8), (27, 4)]


@pytest.mark.parametrize("kv", [None, "int8"])
def test_engine_token_exact_vs_jax_engine(rng, kv):
    """A wave of mixed prompts through 2 slots — one prompt (27) longer
    than prefill_len (16), admitted in two chunks — must give the JAX
    ServingEngine's greedy tokens exactly."""
    from paddle_tpu.serving import ServeConfig as JServe
    from paddle_tpu.serving import ServingEngine as JEngine
    from paddle_tpu_torch.serving import ServeConfig, ServingEngine
    jm, v, pm = _pair(seed=1)
    kw = dict(num_slots=2, page_size=8, max_len=40, prefill_len=16)
    je = JEngine(jm, v, JServe(**kw, prefix_cache=False,
                                kv_dtype=jnp.int8 if kv else None))
    pe = ServingEngine(pm, ServeConfig(**kw, prefix_cache=False,
                                       kv_dtype=torch.int8 if kv else None))
    prompts = [rng.randint(0, 512, (n,)).astype(np.int32) for n, _ in SPECS]
    for p, (_, mn) in zip(prompts, SPECS):
        je.submit(p, max_new=mn)
        pe.submit(p, max_new=mn)
    want = {r.id: r.output for r in je.drain()}
    got = {r.id: r for r in pe.drain()}
    assert sorted(got) == sorted(want)
    for rid, req in got.items():
        np.testing.assert_array_equal(req.output, want[rid])
        assert req.status == "done" and req.retire_reason == "length"
    assert pe.prefill_calls == len(SPECS) + 1        # the 27-token prompt
    assert sorted(pe._free_slots) == [0, 1]
    assert len(pe._free_pages) == pe.cfg.num_pages
    assert not pe._page_table.any() and not pe._lengths.any()


def test_engine_eos_and_refusals(rng):
    from paddle_tpu_torch.core.enforce import EnforceError
    from paddle_tpu_torch.serving import ServeConfig, ServingEngine
    _, _, pm = _pair()
    eng = ServingEngine(pm, ServeConfig(num_slots=2, page_size=8,
                                        max_len=32, prefill_len=16))
    prompt = rng.randint(0, 512, (6,)).astype(np.int32)
    rid = eng.submit(prompt, max_new=8)
    first = eng.drain()[0].tokens
    eos = first[2]
    rid = eng.submit(prompt, max_new=8, eos_id=eos)
    req = {r.id: r for r in eng.drain()}[rid]
    assert req.tokens == first[:first.index(eos) + 1]
    assert req.retire_reason == "eos"
    with pytest.raises(EnforceError):
        eng.submit(np.zeros(30, np.int32), max_new=8)     # > max_len
    with pytest.raises(EnforceError):        # not even one request fits
        ServeConfig(num_slots=2, page_size=8, max_len=32, num_pages=3
                    ).resolve()


def test_unported_branches_raise():
    """The multi-GPU options raise; the decoder refuses scan_layers, as
    the reference's does (MoE and scan_layers are ported)."""
    from paddle_tpu_torch.core.enforce import EnforceError
    from paddle_tpu_torch.models.gpt import GPTConfig, GPTDecoder
    for kw in ({"seq_axis": "sp"}, {"moe_experts": 4, "moe_ep_axis": "ep"}):
        cfg = GPTConfig.tiny()
        for k, val in kw.items():
            setattr(cfg, k, val)
        with pytest.raises(NotImplementedError):
            GPTDecoder(cfg, device="cpu")
    cfg = GPTConfig.tiny()
    cfg.scan_layers = True
    with pytest.raises(EnforceError):
        GPTDecoder(cfg, device="cpu")


@pytest.fixture
def fast_retry(flags_guard):
    """The JAX engine's recovery backoff in microseconds."""
    set_flags({"retry_backoff_base_s": 0.001, "retry_jitter": 0.0})


def test_staged_prompts_token_exact_vs_jax_through_preemption_and_recovery(
        rng, fast_retry):
    """Prompts are staged at submit as ceil(len / prefill_len) chunks and
    every prefill call reads its chunk: through chunked prefill (prompts
    up to 3 chunks), preemption at a pool of 5 pages and an injected
    ``serve.step`` fault whose recovery restages each victim's prompt +
    generated tokens, the greedy tokens equal the JAX engine's (which
    stages too) under the same plan. Retirement drops the chunks."""
    from paddle_tpu.serving import ServeConfig as JServe
    from paddle_tpu.serving import ServingEngine as JEngine
    from paddle_tpu.testing import chaos as jchaos
    from paddle_tpu_torch.serving import ServeConfig, ServingEngine
    from paddle_tpu_torch.testing import chaos
    jm, v, pm = _pair(seed=1)
    kw = dict(num_slots=2, page_size=8, max_len=40, prefill_len=8,
              num_pages=5, step_retries=3)
    je = JEngine(jm, v, JServe(**kw))
    pe = ServingEngine(pm, ServeConfig(**kw), sleep=lambda s: None)
    staged = []
    real_stage = pe._stage_chunks
    pe._stage_chunks = lambda seq: (staged.append(np.array(seq)),
                                    real_stage(seq))[1]
    specs = [(19, 12), (11, 16), (5, 14), (22, 10)]
    prompts = [rng.randint(0, 512, (n,)).astype(np.int32) for n, _ in specs]
    for p, (_, mn) in zip(prompts, specs):
        je.submit(p, max_new=mn)
        pe.submit(p, max_new=mn)
    assert [len(q) for q in staged] == [n for n, _ in specs]
    assert [len(pe.requests[i].device_prompt) for i in range(4)] == \
        [3, 2, 1, 3]
    jplan = jchaos.FaultPlan(seed=0).fail("fault_point",
                                          path=r"^serve\.step$", nth=30)
    with jchaos.active(jplan):
        je.drain()
    plan = chaos.FaultPlan().fail("fault_point", path=r"^serve\.step$",
                                  nth=30)
    with chaos.active(plan):
        pe.drain()
    je.close()
    assert plan.fired() == jplan.fired() == 1
    assert pe.recoveries == je.recoveries == 1
    assert pe.preemptions >= 1
    assert pe.preemptions == sum(r.preemptions
                                 for r in je.requests.values())
    # each restage is a recovered request's prompt + the tokens it had
    restaged = staged[len(specs):]
    assert restaged
    for seq in restaged:
        owner = [r for r in pe.requests.values() if r.recoveries
                 and len(seq) > r.prompt.size
                 and np.array_equal(r.output[:len(seq)], seq)]
        assert len(owner) == 1, seq
    for rid in range(len(specs)):
        got = pe.requests[rid]
        np.testing.assert_array_equal(got.output, je.requests[rid].output)
        assert got.status == "done" and got.device_prompt is None
    assert pe.staged_prefills == pe.prefill_calls > len(specs)
