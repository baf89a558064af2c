"""The port's speculative decoding against the JAX package, on a 2-layer
hidden-64 GPT (``GPTConfig.tiny()``, dropout 0) with the weights carried
over by the bridge.

Tolerances: ``paged_verify_chunk``'s hidden states, ``verify_head``'s
logits and the window's pool writes within 1e-5 of JAX (two layers of
f32 matmuls summed in other orders; an int8 pool row may round to the
neighbouring step, so int8 values are held within 1 and their scales
within 1e-5). Engine tokens are held exactly: greedy speculative serving
against the JAX speculative engine and against the port's spec-off
engine, with ``spec_stats()`` equal to the JAX engine's; sampled
requests against the port's spec-off engine (the two packages draw from
different generators).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.core.flags import all_flags, set_flags

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
SERVE = dict(num_slots=2, page_size=8, max_len=64, prefill_len=16)


@pytest.fixture
def fast_retry():
    """Recovery backoff of a millisecond on the JAX side (the port's
    engines sleep through an injected no-op)."""
    saved = all_flags()
    set_flags({"retry_backoff_base_s": 0.001, "retry_jitter": 0.0})
    yield
    set_flags(saved)


_CACHE = {}


def _models():
    """(JAX target, its variables, port target, JAX 1-layer draft spec,
    port draft spec, draft variables as numpy): built once per file."""
    if not _CACHE:
        from paddle_tpu.models.gpt import GPTConfig, GPTDecoder
        from paddle_tpu_torch import bridge
        from paddle_tpu_torch.models.gpt import GPTConfig as PConfig
        from paddle_tpu_torch.models.gpt import GPTDecoder as PDecoder
        cfg = GPTConfig.tiny()
        cfg.dropout = 0.0
        jm = GPTDecoder(cfg)
        v = jm.init(jax.random.key(3))
        pcfg = PConfig.tiny()
        pcfg.dropout = 0.0
        pm = PDecoder(pcfg, device="cpu", seed=99).eval()
        bridge.load_params(pm, jax.tree_util.tree_map(np.asarray,
                                                      v["params"]))
        dcfg = GPTConfig.tiny()
        dcfg.dropout = 0.0
        dcfg.num_layers = 1
        dv = GPTDecoder(dcfg).init(jax.random.key(4))
        pdcfg = PConfig.tiny()
        pdcfg.dropout = 0.0
        pdcfg.num_layers = 1
        _CACHE["m"] = (jm, v, pm, dcfg, pdcfg,
                       {"params": jax.tree_util.tree_map(np.asarray,
                                                         dv["params"])})
    return _CACHE["m"]


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _jax_engine(**kw):
    from paddle_tpu.serving import ServeConfig, ServingEngine
    jm, v, _, dcfg, _, dv = _models()
    if kw.pop("cut_draft", False):
        kw.update(draft_spec=dcfg, draft_variables=dv)
    return ServingEngine(jm, v, ServeConfig(**dict(SERVE, **kw)))


def _port_engine(**kw):
    from paddle_tpu_torch.serving import ServeConfig, ServingEngine
    _, _, pm, _, pdcfg, dv = _models()
    if kw.pop("cut_draft", False):
        kw.update(draft_spec=pdcfg, draft_variables=dv)
    return ServingEngine(pm, ServeConfig(**dict(SERVE, **kw)),
                         sleep=lambda s: None)


def _prompts(rng, lens):
    return [rng.randint(0, 512, (n,)).astype(np.int32) for n in lens]


def _serve(eng, prompts, max_new=9, **submit_kw):
    """Submit every prompt, drain; returns each request's tokens."""
    rids = [eng.submit(p, max_new=max_new, **submit_kw) for p in prompts]
    eng.drain()
    out = [eng.requests[r] for r in rids]
    assert all(r.status == "done" for r in out)
    return [list(r.tokens) for r in out]


# ------------------------------------------------- (a) the model methods

@pytest.mark.parametrize("kv", [None, "int8"])
def test_verify_chunk_and_head_match_jax(rng, kv):
    """Three slots prefilled (one of them in two chunks), then one verify
    window per slot (windows of 4, 2 and 0 tokens; the last row is dead):
    hidden states, each position's ``verify_head`` logits and the pools
    after the window's writes within 1e-5 of JAX."""
    jm, v, pm, _, _, _ = _models()
    n_pages, ps, lp, w = 12, 4, 8, 4
    jc = jm.init_paged_caches(n_pages, ps, kv_dtype=jnp.int8 if kv else None)
    pc = pm.init_paged_caches(n_pages, ps,
                              kv_dtype=torch.int8 if kv else None)
    rows = np.asarray([[3, 7, 1, 9], [2, 0, 5, 6], [11, 4, 8, 10]],
                      np.int32)

    def jcall(fn, *args, **kw):
        return jm.apply(v, jnp.zeros((1,)), method=lambda _: fn(*args, **kw))

    lengths = np.asarray([11, 6, 5], np.int32)
    with torch.no_grad():
        for s in range(3):
            for start in range(0, int(lengths[s]), lp):
                clen = min(lp, int(lengths[s]) - start)
                chunk = rng.randint(0, 512, (1, lp)).astype(np.int32)
                args = (np.asarray([start], np.int32),
                        np.asarray([clen], np.int32))
                jc = jcall(jm.paged_prefill_chunk, jnp.asarray(chunk),
                           jnp.asarray(args[0]), jnp.asarray(args[1]), jc,
                           jnp.asarray(rows[s:s + 1]))[1]
                pm.paged_prefill_chunk(
                    torch.from_numpy(chunk), torch.from_numpy(args[0]),
                    torch.from_numpy(args[1]), pc,
                    torch.from_numpy(rows[s:s + 1]))
        window = rng.randint(0, 512, (3, w)).astype(np.int32)
        wins = np.asarray([4, 2, 0], np.int32)

        def jverify(wt):
            hidden, caches = jm.paged_verify_chunk(
                wt, jnp.asarray(lengths), jnp.asarray(wins), jc,
                jnp.asarray(rows))
            return hidden, [jm.verify_head(hidden[:, i]) for i in range(w)], \
                caches

        jh, jlogits, jpools = jm.apply(v, jnp.asarray(window),
                                       method=jverify)
        ph, pools = pm.paged_verify_chunk(
            torch.from_numpy(window), torch.from_numpy(lengths),
            torch.from_numpy(wins), pc, torch.from_numpy(rows))
        np.testing.assert_allclose(_np(ph), np.asarray(jh), **TOL)
        for i in range(w):
            got = pm.verify_head(ph[:, i])
            assert got.shape == (3, 512)
            np.testing.assert_allclose(_np(got), np.asarray(jlogits[i]),
                                       **TOL)
    for jp, pp in zip(jpools, pools):
        for name in jp:
            want = np.asarray(jp[name], np.float32)
            if name in ("k", "v") and kv:
                np.testing.assert_allclose(_np(pp[name]), want, atol=1)
            else:
                np.testing.assert_allclose(_np(pp[name]), want, **TOL)


# ------------------------------------------- (b) engines against JAX's

@pytest.mark.parametrize("draft", ["self", "cut"])
def test_greedy_speculation_token_exact_vs_jax_and_spec_off(rng, draft):
    """Greedy waves of short and chunked prompts: the port's speculative
    engine gives the JAX speculative engine's tokens and ``spec_stats()``
    (acceptance included, so a missing draft-pool mirror would show),
    and the port's spec-off engine's tokens. With self-draft every
    target step emits more than one token on average."""
    prompts = _prompts(rng, (5, 30, 11, 20, 40, 17))
    kw = dict(draft=True, spec_k=3, cut_draft=draft == "cut")
    je = _jax_engine(**kw)
    want = _serve(je, prompts)
    pe = _port_engine(**kw)
    got = _serve(pe, prompts)
    off = _serve(_port_engine(), prompts)
    assert got == want == off
    stats = pe.spec_stats()
    assert stats == je.spec_stats()
    assert stats["proposed"] == stats["accepted"] + stats["rollbacks"] > 0
    assert sum(r.spec_tokens for r in pe.requests.values()) \
        == sum(r.spec_tokens for r in je.requests.values())
    if draft == "self":
        assert stats["tokens_per_target_step"] > 1.0
    je.close()


def test_sampled_requests_identical_with_speculation_on_and_off(rng):
    """Sampled requests (a mix of temperature, top-k, top-p and seeds)
    emit the same tokens with speculation on (self-draft and a separate
    draft) and off: each position is drawn with the key of the plain
    path."""
    prompts = _prompts(rng, (7, 25, 12, 3))
    kw = dict(temperature=0.9, top_k=40, top_p=0.95)
    outs = []
    for spec in ({}, dict(draft=True, spec_k=3),
                 dict(draft=True, spec_k=2, cut_draft=True)):
        eng = _port_engine(**spec)
        rids = [eng.submit(p, max_new=10, seed=100 + i, **kw)
                for i, p in enumerate(prompts)]
        rids.append(eng.submit(prompts[0], max_new=10))      # one greedy
        eng.drain()
        outs.append([eng.requests[r].tokens for r in rids])
        if spec:
            assert eng.spec_stats()["rounds"] > 0
    assert outs[0] == outs[1] == outs[2]


# -------------------------------- (c) prefix cache, CoW, famine, faults

def test_prefix_cache_cow_and_preemption_under_speculation(rng):
    """A shared prefix (hits and a copy-on-write) and a pool too small
    for both slots (window famine, then preemption): the speculative
    engine's tokens equal the spec-off engine's and the JAX speculative
    engine's, and so do ``spec_stats()`` (a copy-on-write page missing
    from the draft's pools would lower the acceptance) and the
    preemptions; the counters say each path ran."""
    shared = rng.randint(0, 512, (16,)).astype(np.int32)
    prompts = [np.concatenate([shared, rng.randint(0, 512, (3,))]),
               shared.copy(),       # capped inside its last page
               np.concatenate([shared, rng.randint(0, 512, (9,))]),
               rng.randint(0, 512, (6,)).astype(np.int32)]
    kw = dict(num_pages=6, max_len=40)
    off = _port_engine(**kw)
    want = _serve(off, prompts, max_new=14)
    pe = _port_engine(draft=True, spec_k=3, **kw)
    got = _serve(pe, prompts, max_new=14)
    je = _jax_engine(draft=True, spec_k=3, **kw)
    assert got == want == _serve(je, prompts, max_new=14)
    assert pe.spec_stats() == je.spec_stats()
    assert [r.preemptions for r in pe.requests.values()] \
        == [r.preemptions for r in je.requests.values()]
    je.close()
    assert pe.prefix_hits > 0 and pe.cow_copies > 0
    assert pe.preemptions > 0 and pe.spec_stats()["rounds"] > 0
    assert pe._pages_available() == pe.cfg.num_pages


@pytest.mark.parametrize("where", ["serve.step", "spec.verify"])
def test_faults_under_speculation_token_exact(rng, fast_retry, where):
    """A ``serve.step`` fault mid-round is recovered (both page pools
    rebuilt) and a ``spec.verify`` fault degrades that round to one plain
    decode step: tokens equal the clean run's and the JAX engine's under
    the same plan, and so do the recoveries and ``spec_stats()``."""
    from paddle_tpu.testing import chaos as jchaos
    from paddle_tpu_torch.testing import chaos
    prompts = _prompts(rng, (6, 22, 10))
    kw = dict(draft=True, spec_k=3, step_retries=3)
    clean = _serve(_port_engine(**kw), prompts)
    pattern = "^" + where.replace(".", r"\.") + "$"
    je, pe = _jax_engine(**kw), _port_engine(**kw)
    jplan = jchaos.FaultPlan(seed=0).fail("fault_point", path=pattern, nth=9)
    with jchaos.active(jplan):
        want = _serve(je, prompts)
    plan = chaos.FaultPlan().fail("fault_point", path=pattern, nth=9)
    with chaos.active(plan):
        got = _serve(pe, prompts)
    assert plan.fired() == jplan.fired() == 1
    assert got == want == clean
    assert pe.recoveries == je.recoveries == (where == "serve.step")
    assert pe.spec_stats() == je.spec_stats()
    if where == "spec.verify":
        assert pe.decode_steps == 1
    je.close()


# ---------------------------------------------- (d) the draft's weights

def test_draft_checkpoint_restore_and_empty_directory(rng, tmp_path):
    """``draft_checkpoint``: the newest step of a CheckpointManager
    directory holding ``{"params": {name: tensor}}`` gives the draft the
    weights that ``draft_variables`` gives, token for token; a directory
    with no step raises."""
    from paddle_tpu_torch.core.enforce import EnforceError
    from paddle_tpu_torch.io.checkpoint import CheckpointManager
    _, _, _, _, pdcfg, _ = _models()
    ref = _port_engine(draft=True, spec_k=3, cut_draft=True)
    named = dict(ref._draft_model.named_parameters())
    mgr = CheckpointManager(str(tmp_path / "draft"))
    mgr.save(1, {"params": {k: torch.zeros_like(p)
                            for k, p in named.items()}})
    mgr.save(2, {"params": named})
    mgr.close()                    # both saves land before the engine reads
    eng = _port_engine(draft_spec=pdcfg, draft_checkpoint=str(
        tmp_path / "draft"))
    assert eng.cfg.draft and eng.cfg.spec_k == 3
    for name, p in eng._draft_model.named_parameters():
        assert torch.equal(p, named[name])
    prompts = _prompts(rng, (9, 18))
    assert _serve(eng, prompts) == _serve(ref, prompts)
    assert eng.spec_stats() == ref.spec_stats()
    (tmp_path / "empty").mkdir()
    with pytest.raises(EnforceError):
        _port_engine(draft_spec=pdcfg,
                     draft_checkpoint=str(tmp_path / "empty"))


def test_spec_config_resolution_matches_jax():
    """``resolve()``: an explicit draft spec or checkpoint turns ``draft``
    on, ``spec_k`` < 1 with a draft is refused, and the defaults are the
    reference flags' (draft off, spec_k 3)."""
    from paddle_tpu.serving import ServeConfig as JServe
    from paddle_tpu_torch.core.enforce import EnforceError
    from paddle_tpu_torch.serving import ServeConfig
    _, _, _, dcfg, pdcfg, _ = _models()
    for cfg, other in ((ServeConfig(), JServe()),
                       (ServeConfig(draft_spec=pdcfg),
                        JServe(draft_spec=dcfg)),
                       (ServeConfig(draft_checkpoint="d"),
                        JServe(draft_checkpoint="d"))):
        cfg.resolve()
        other.resolve()
        assert (cfg.draft, cfg.spec_k) == (other.draft, other.spec_k)
    with pytest.raises(EnforceError):
        ServeConfig(draft=True, spec_k=0).resolve()
