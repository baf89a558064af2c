"""The port's serving features against the JAX package: the prefix cache,
``copy_pages``, the prefill write floor, per-request sampling, preemption,
bounded admission and step recovery, on GPTConfig.tiny() with the weights
carried over by the bridge (dropout 0).

Tolerances: logits within 1e-4 (as in test_torch_serving.py: two layers
of f32 matmuls summed in other orders, plus the vocab head); pools within
1e-5, and bitwise where a page must be left untouched or copied. Greedy
engine tokens are held exactly. Sampled tokens cannot equal JAX's (its
draws come from threefry, the port's from Philox), so what is held is
the kept set (equal to the support of 4000 JAX draws) and the
distribution (a two-sample chi-square with p > 1e-3).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.core.flags import all_flags, set_flags

torch.set_num_threads(1)

LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
POOL_TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture
def fast_retry():
    """Recovery backoff of a millisecond on the JAX side (the port's
    engines sleep through an injected no-op)."""
    saved = all_flags()
    set_flags({"retry_backoff_base_s": 0.001, "retry_jitter": 0.0})
    yield
    set_flags(saved)


def _pair(seed=1):
    """(jax model, jax variables, port model) with identical weights."""
    from paddle_tpu.models.gpt import GPTConfig, GPTDecoder
    from paddle_tpu_torch import bridge
    from paddle_tpu_torch.models.gpt import GPTConfig as PConfig
    from paddle_tpu_torch.models.gpt import GPTDecoder as PDecoder
    cfg = GPTConfig.tiny()
    cfg.dropout = 0.0
    jm = GPTDecoder(cfg)
    v = jm.init(jax.random.key(seed))
    pcfg = PConfig.tiny()
    pcfg.dropout = 0.0
    pm = PDecoder(pcfg, device="cpu", seed=seed + 100).eval()
    bridge.load_params(pm, jax.tree_util.tree_map(np.asarray, v["params"]))
    return jm, v, pm


_PAIR = {}


def _shared_pair():
    """One model pair for the engine tests of this file (built once)."""
    if not _PAIR:
        _PAIR["pair"] = _pair()
    return _PAIR["pair"]


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _engines(kv=None, **kw):
    """(JAX engine, port engine) on the shared pair with the same
    ServeConfig fields."""
    from paddle_tpu.serving import ServeConfig as JServe
    from paddle_tpu.serving import ServingEngine as JEngine
    from paddle_tpu_torch.serving import ServeConfig, ServingEngine
    jm, v, pm = _shared_pair()
    je = JEngine(jm, v, JServe(**kw, kv_dtype=jnp.int8 if kv else None))
    pe = ServingEngine(pm, ServeConfig(**kw, kv_dtype=torch.int8 if kv
                                       else None), sleep=lambda s: None)
    return je, pe


def _cow_total():
    from paddle_tpu.observability import metrics as _metrics
    return _metrics.counter("serve.cow_copies").total()


# ------------------------------------------------------ (a) prefix cache

def _script(mod, idle):
    """One scripted sequence of every PrefixCache method; returns every
    result and the counters. ``idle`` > 0 trims idle pages on release."""
    pc = mod.PrefixCache(4, max_idle_pages=idle)
    a = list(range(1, 13))                   # 3 full pages
    b = a[:8] + [99, 98, 97, 96, 5]          # shares 2 pages, then diverges
    out = [pc.match(a, cap=11)]
    out.append(pc.insert(a, [10, 11, 12]))
    out.append(pc.match(a, cap=11))          # capped inside page 3
    out.append(pc.match(b, cap=12))
    pc.acquire(out[-1][0])                   # the pages b matched
    out.append(pc.insert(b, [10, 11, 20]))
    out.append(pc.lookup_depth(b))
    out.append(pc.release([10, 11, 12]))
    out.append((pc.evictable(), pc.pages_shared()))
    out.append(pc.release([10, 11, 20, 77]))  # 77: unknown -> free
    out.append(pc.evict(2))                   # LRU order
    out.append(pc.match(a, cap=11))
    out.append((len(pc), pc.hits, pc.misses, pc.collisions, pc.evictions))
    pc.clear()
    out.append((len(pc), pc.match(a, cap=11)))
    return out


@pytest.mark.parametrize("idle", [0, 1])
@pytest.mark.parametrize("collide", [False, True])
def test_prefix_cache_script_matches_jax(monkeypatch, collide, idle):
    """The same scripted calls give identical results in both modules,
    with the idle-page trim off (0) and on (1); with ``page_key``
    monkeypatched to a constant every key collides and the content check
    turns each hit into a miss."""
    from paddle_tpu.serving import prefix_cache as jpc
    from paddle_tpu_torch.serving import prefix_cache as ppc
    if collide:
        for mod in (jpc, ppc):
            monkeypatch.setattr(mod, "page_key", lambda parent, toks: b"k")
    want, got = _script(jpc, idle), _script(ppc, idle)
    assert got == want
    if collide:
        assert got[-2][3] > 0                  # collisions counted
    else:
        assert got[2] == ([10, 11, 12], 11)    # the cap cuts page 3
    if idle and not collide:
        assert got[8] == [77, 12, 10, 11]      # trimmed to 1 idle (20)


# ------------------------------------------------------ (b) copy_pages

@pytest.mark.parametrize("kv", [None, "int8"])
def test_copy_pages_matches_jax(rng, kv):
    """Whole pages copied in place in every entry of the pool (an int8
    pool's scales with them, bit-exact), an out-of-range dst dropped,
    all sources read before any write."""
    from paddle_tpu.ops import attention as jatt
    from paddle_tpu_torch.ops import attention as patt
    n, h, ps, hd = 6, 2, 4, 8
    if kv:
        pool = {"k": rng.randint(-127, 128, (n, h, ps, hd)).astype(np.int8),
                "v": rng.randint(-127, 128, (n, h, ps, hd)).astype(np.int8),
                "k_scale": rng.rand(n, ps).astype(np.float32),
                "v_scale": rng.rand(n, ps).astype(np.float32)}
    else:
        pool = {"k": rng.randn(n, h, ps, hd).astype(np.float32),
                "v": rng.randn(n, h, ps, hd).astype(np.float32)}
    src = np.asarray([1, 4, 2, 0], np.int32)
    dst = np.asarray([3, n, 1, 5], np.int32)    # n: dropped; 1 is a src
    want = jatt.copy_pages({k: jnp.asarray(a) for k, a in pool.items()},
                           jnp.asarray(src), jnp.asarray(dst))
    ppool = {k: torch.from_numpy(a.copy()) for k, a in pool.items()}
    out = patt.copy_pages(ppool, torch.from_numpy(src), torch.from_numpy(dst))
    assert out is ppool                          # in place
    for name in pool:
        np.testing.assert_array_equal(ppool[name].numpy(),
                                      np.asarray(want[name]))
    np.testing.assert_array_equal(ppool["k"][1].numpy(), pool["k"][2])
    for untouched in (0, 2, 4):
        np.testing.assert_array_equal(ppool["v"][untouched].numpy(),
                                      pool["v"][untouched])
    gone = {k: torch.from_numpy(a.copy()) for k, a in pool.items()}
    patt.copy_pages(gone, torch.tensor([1]), torch.tensor([n + 3]))
    for name in pool:                            # only a dropped copy
        np.testing.assert_array_equal(gone[name].numpy(), pool[name])


# ------------------------------------------------- (c) prefill write floor

def _row(pool_entry, page, off):
    """One token row of a pool entry: ``[H, hd]`` of K/V, or a scale."""
    if pool_entry.ndim == 4:
        return pool_entry[page, :, off, :]
    return pool_entry[page, off]


@pytest.mark.parametrize("kv", [None, "int8"])
def test_prefill_write_floor_matches_jax(rng, kv):
    """A continuation chunk and a first chunk with write floors inside
    them: logits within 1e-4 of JAX, pools equal, and every page row
    below the floor bitwise unchanged (they stand for shared pages)."""
    jm, v, pm = _shared_pair()
    n_pages, ps, lp = 10, 4, 8
    jc = jm.init_paged_caches(n_pages, ps, kv_dtype=jnp.int8 if kv else None)
    pc = pm.init_paged_caches(n_pages, ps,
                              kv_dtype=torch.int8 if kv else None)
    rows = np.asarray([[2, 5, 7, 1, 0, 0]], np.int32)

    def jcall(fn, *args, **kw):
        return jm.apply(v, jnp.zeros((1,)), method=lambda _: fn(*args, **kw))

    prompt = rng.randint(0, 512, (1, lp)).astype(np.int32)
    start = np.asarray([0], np.int32)
    lens = np.asarray([lp], np.int32)
    with torch.no_grad():
        jout = jcall(jm.paged_prefill_chunk, jnp.asarray(prompt),
                     jnp.asarray(start), jnp.asarray(lens), jc,
                     jnp.asarray(rows))
        pm.paged_prefill_chunk(torch.from_numpy(prompt),
                               torch.from_numpy(start),
                               torch.from_numpy(lens), pc,
                               torch.from_numpy(rows))
        jc = jout[1]
        for s0, floor, clen in ((8, 10, 7), (0, 5, 8)):
            before = [{k: t.clone() for k, t in pool.items()} for pool in pc]
            chunk = rng.randint(0, 512, (1, lp)).astype(np.int32)
            args = (np.asarray([s0], np.int32), np.asarray([clen], np.int32))
            jout = jcall(jm.paged_prefill_chunk, jnp.asarray(chunk),
                         jnp.asarray(args[0]), jnp.asarray(args[1]), jc,
                         jnp.asarray(rows),
                         write_floor=jnp.asarray([floor], jnp.int32))
            pout = pm.paged_prefill_chunk(
                torch.from_numpy(chunk), torch.from_numpy(args[0]),
                torch.from_numpy(args[1]), pc, torch.from_numpy(rows),
                write_floor=torch.tensor([floor], dtype=torch.int32))
            np.testing.assert_allclose(_np(pout[0]), np.asarray(jout[0]),
                                       **LOGIT_TOL)
            for jp, pp in zip(jout[1], pc):
                for name in jp:
                    np.testing.assert_allclose(
                        _np(pp[name]), np.asarray(jp[name], np.float32),
                        **POOL_TOL)
            for old, new in zip(before, pc):
                for name in new:
                    for pos in range(floor):     # below the floor
                        page, off = rows[0, pos // ps], pos % ps
                        assert torch.equal(_row(new[name], page, off),
                                           _row(old[name], page, off))
            jc = jout[1]


# ------------------------------------------------------------ (d) sampling

V = 32


def _logit_rows():
    """Row 0: spread logits; row 1: ties (a tied block at the top, so
    top_k = 2 cuts inside it and every tied entry is kept)."""
    rs = np.random.RandomState(0)
    r0 = (rs.randn(V) * 0.6).astype(np.float32)
    r1 = np.round(rs.randn(V) * 0.5, 1).astype(np.float32)
    r1[[3, 11, 20]] = 1.9                        # three-way tie at the top
    r1[[5, 6]] = 1.2                             # and a pair below it
    return np.stack([r0, r1])


KNOBS = [(1.0, 0, 0.0), (0.7, 5, 0.0), (1.3, 0, 0.6), (0.9, 8, 0.85),
         (1.0, 2, 0.0), (2.0, 0, 0.99)]


def _nucleus_margin(row, temp, p):
    """Distance of every ``cum - probs`` from ``p`` in float64: the
    nucleus edge must not sit where f32 sums in XLA's and torch's orders
    could put it on different sides."""
    s = np.sort(row.astype(np.float64) / max(temp, 1e-6))[::-1]
    e = np.exp(s - s.max())
    probs = e / e.sum()
    return np.abs(np.cumsum(probs) - probs - p).min()


def _jax_draws(logits, knob, n):
    """``n`` draws of the JAX engine's sampler (``engine._sample``) for
    one logits row over (seed, count) pairs."""
    temp, k, p = knob
    toks = _jax_sampler_engine()._sample(
        jnp.asarray(np.repeat(logits[None], n, 0)),
        jnp.full((n,), temp, jnp.float32), jnp.full((n,), k, jnp.int32),
        jnp.full((n,), p, jnp.float32),
        jnp.asarray((np.arange(n) // 40).astype(np.uint32)),
        jnp.asarray((np.arange(n) % 40).astype(np.int32)))
    return np.asarray(toks)


_JSAMPLER = {}


def _jax_sampler_engine():
    if not _JSAMPLER:
        from paddle_tpu.serving import ServeConfig as JServe
        from paddle_tpu.serving import ServingEngine as JEngine
        jm, v, _ = _shared_pair()
        _JSAMPLER["e"] = JEngine(jm, v, JServe(num_slots=1, page_size=8,
                                               max_len=16, prefill_len=8))
    return _JSAMPLER["e"]


def _port_draws(logits, knob, n, base_seed=0):
    """``n`` draws of the port's sampler over the same (seed, count)
    pairs as :func:`_jax_draws`."""
    from paddle_tpu_torch.serving.sampling import sample
    temp, k, p = knob
    return sample(torch.from_numpy(np.repeat(logits[None], n, 0)),
                  torch.full((n,), temp), torch.full((n,), k),
                  torch.full((n,), p), torch.arange(n) // 40,
                  torch.arange(n) % 40, base_seed).numpy()


@pytest.mark.parametrize("row", [0, 1])
@pytest.mark.parametrize("knob", KNOBS)
def test_sampling_support_and_distribution_match_jax(row, knob):
    """For one logits row and one (temperature, top_k, top_p): the port's
    kept set equals the support of 4000 JAX draws, the port's own 4000
    draws stay inside it, and a two-sample chi-square between the two
    sets of draw counts gives p > 1e-3."""
    from scipy.stats import chi2_contingency
    from paddle_tpu_torch.serving.sampling import sampling_mask
    logits = _logit_rows()[row]
    temp, k, p = knob
    if 0.0 < p < 1.0:
        assert _nucleus_margin(logits, temp, p) > 1e-5   # test data sanity
    _, keep = sampling_mask(torch.from_numpy(logits[None]),
                            torch.tensor([temp]), torch.tensor([k]),
                            torch.tensor([p]))
    kept = set(np.flatnonzero(keep[0].numpy()).tolist())
    n = 4000
    jd = _jax_draws(logits, knob, n)
    pd = _port_draws(logits, knob, n)
    assert set(np.unique(jd).tolist()) == kept
    assert set(np.unique(pd).tolist()) <= kept
    if row == 1 and k == 2:
        assert kept == {3, 11, 20}              # the tie at kth kept whole
    if len(kept) > 1:
        cols = sorted(kept)
        table = np.stack([np.bincount(jd, minlength=V)[cols],
                          np.bincount(pd, minlength=V)[cols]])
        assert chi2_contingency(table)[1] > 1e-3


def test_sampling_greedy_rows_and_top_k_one():
    """``temperature == 0`` rows are bitwise ``argmax`` (first index on
    ties) beside sampled rows in one batch; ``top_k = 1`` equals greedy;
    masked entries never win against the Gumbel noise."""
    from paddle_tpu_torch.serving.sampling import sample
    rows = _logit_rows()
    tie = np.zeros(V, np.float32)
    tie[[7, 9]] = 5.0                            # argmax tie: index 7
    logits = torch.from_numpy(np.stack([rows[0], rows[1], tie, rows[0],
                                        rows[1]]))
    temps = torch.tensor([0.0, 0.0, 0.0, 0.8, 1.5])
    out = sample(logits, temps, torch.tensor([0, 0, 0, 1, 0]),
                 torch.tensor([0.0, 0.0, 0.0, 0.0, 0.9]),
                 torch.arange(5), torch.zeros(5, dtype=torch.int64), 3)
    greedy = torch.argmax(logits, -1)
    assert torch.equal(out[:3], greedy[:3]) and int(out[2]) == 7
    assert int(out[3]) == int(greedy[3])          # top_k = 1
    d = _port_draws(rows[0], (1.7, 1, 0.0), 500)
    assert (d == int(np.argmax(rows[0]))).all()
    # extreme logits: kept entries still beat every masked one
    wide = np.full(V, -60.0, np.float32)
    wide[4] = 60.0
    d = _port_draws(wide, (1e-3, 3, 0.0), 200)
    assert set(d.tolist()) <= {4} | set(np.argsort(-wide)[:3].tolist())


def test_sampling_stream_is_per_request():
    """(e): the draw for token i of a request depends only on
    (base seed, request seed, i): the same row in another batch position
    beside other rows, or alone, draws the same token; another base seed
    or request seed draws another stream."""
    from paddle_tpu_torch.serving.sampling import sample, uniforms
    rs = np.random.RandomState(5)
    logits = torch.from_numpy(rs.randn(6, 400).astype(np.float32) * 2)
    temps = torch.full((6,), 0.9)
    ks = torch.tensor([0, 50, 0, 20, 0, 0])
    ps = torch.tensor([0.0, 0.0, 0.95, 0.9, 0.0, 0.0])
    seeds = torch.tensor([11, 12, 13, 14, 15, 16])
    counts = torch.tensor([0, 3, 9, 1, 2, 7])
    full = sample(logits, temps, ks, ps, seeds, counts, 4)
    perm = torch.tensor([5, 2, 0, 4, 1, 3])
    shuffled = sample(logits[perm], temps[perm], ks[perm], ps[perm],
                      seeds[perm], counts[perm], 4)
    assert torch.equal(shuffled, full[perm])
    for i in range(6):
        alone = sample(logits[i:i + 1], temps[i:i + 1], ks[i:i + 1],
                       ps[i:i + 1], seeds[i:i + 1], counts[i:i + 1], 4)
        assert int(alone) == int(full[i])
    u = uniforms(4, seeds, counts, 400)
    assert not torch.equal(u, uniforms(5, seeds, counts, 400))
    assert not torch.equal(u, uniforms(4, seeds + 1, counts, 400))
    assert not torch.equal(u, uniforms(4, seeds, counts + 1, 400))
    assert float(u.min()) > 0.0 and float(u.max()) < 1.0


def test_engine_sampled_stream_independent_of_slot_and_batch(rng):
    """(e) through the engine: a sampled request gives the same tokens
    alone, in another slot beside other requests, and after being
    preempted (its stream restarts at token 0 from the same seed)."""
    from paddle_tpu_torch.serving import ServeConfig, ServingEngine
    _, _, pm = _shared_pair()
    prompt = rng.randint(0, 512, (9,)).astype(np.int32)
    others = [rng.randint(0, 512, (n,)).astype(np.int32) for n in (5, 12)]
    knobs = dict(temperature=0.9, top_k=40, top_p=0.95, seed=77)

    def run(pre, num_pages=None, priority=0):
        eng = ServingEngine(pm, ServeConfig(
            num_slots=3, page_size=8, max_len=32, prefill_len=8,
            num_pages=num_pages))
        for p in pre:
            eng.submit(p, max_new=20, temperature=1.1, seed=int(p[0]),
                       priority=1)
        rid = eng.submit(prompt, max_new=20, priority=priority, **knobs)
        eng.drain()
        return eng.requests[rid]

    alone = run([])
    beside = run(others)
    assert beside.slot != alone.slot
    preempted = run(others, num_pages=6)
    assert preempted.preemptions >= 1
    assert alone.tokens == beside.tokens == preempted.tokens


# ------------------------------------------------ (f) engine vs JAX engine

def _wave(case, rng):
    """(ServeConfig fields, [(prompt, max_new, priority)]) of one case."""
    r = lambda n: rng.randint(0, 512, (n,)).astype(np.int32)  # noqa: E731
    if case == "hits":            # page-aligned shared prefix, 2 pages
        shared = r(16)
        reqs = [(np.concatenate([shared, r(k)]), 6, 0) for k in (3, 5, 1)]
        reqs.append((r(7), 6, 0))
        return dict(num_slots=2, page_size=8, max_len=48, prefill_len=16,
                    num_pages=12), reqs
    if case == "cow":             # caps inside a cached page
        head = r(20)
        reqs = [(head, 6, 0), (head[:16].copy(), 6, 0),
                (head[:16].copy(), 5, 0), (head.copy(), 4, 0)]
        return dict(num_slots=2, page_size=8, max_len=32, prefill_len=16,
                    num_pages=10), reqs
    if case == "evict":           # a pool too small to keep idle pages
        reqs = [(r(9), 5, 0) for _ in range(3)]
        reqs.append((reqs[0][0].copy(), 5, 0))
        return dict(num_slots=1, page_size=8, max_len=24, prefill_len=16,
                    num_pages=3), reqs
    if case == "trim":            # prefix_pages=2: idle pages trimmed
        a, b = r(20), r(17)       # on release, with the pool never dry
        reqs = [(a, 6, 0), (a.copy(), 6, 0), (b, 6, 0), (a.copy(), 4, 0)]
        return dict(num_slots=1, page_size=8, max_len=40, prefill_len=16,
                    num_pages=12, prefix_pages=2), reqs
    shared = r(8)                 # preempt: deadlocked pool, shared page
    reqs = [(np.concatenate([shared, r(1)]), 12, 0),
            (np.concatenate([shared, r(1)]), 12, 5), (r(6), 10, 0)]
    return dict(num_slots=2, page_size=8, max_len=24, prefill_len=8,
                num_pages=3), reqs


@pytest.mark.parametrize("kv", [None, "int8"])
@pytest.mark.parametrize("case", ["hits", "cow", "evict", "preempt",
                                  "trim"])
def test_engine_prefix_cache_waves_match_jax(rng, case, kv):
    """Greedy waves with the prefix cache on: tokens, per-request
    preemptions, skipped prefill tokens, copy-on-write count, evictions
    and the free pages at the end equal the JAX ServingEngine's."""
    kw, reqs = _wave(case, rng)
    je, pe = _engines(kv=kv, **kw)
    if case == "preempt":
        assert kw["num_pages"] < kw["num_slots"] * -(-kw["max_len"] // 8)
    cow0 = _cow_total()
    for prompt, mn, prio in reqs:
        je.submit(prompt, max_new=mn, priority=prio)
        pe.submit(prompt, max_new=mn, priority=prio)
    want = {r.id: r for r in je.drain()}
    cow = _cow_total() - cow0
    got = {r.id: r for r in pe.drain()}
    je.close()
    assert sorted(got) == sorted(want)
    for rid, req in got.items():
        np.testing.assert_array_equal(req.output, want[rid].output)
        assert req.status == want[rid].status == "done"
        assert req.preemptions == want[rid].preemptions
    assert pe.prefill_tokens_skipped == je.prefill_tokens_skipped
    assert pe.cow_copies == cow
    assert pe.evictions == je._prefix_cache.evictions
    assert pe.prefix_hits == je._prefix_cache.hits
    assert len(pe._free_pages) == len(je._free_pages)
    assert pe._pages_available() == pe.cfg.num_pages
    counter = {"hits": ("prefix_hits", "prefill_tokens_skipped"),
               "cow": ("cow_copies",), "evict": ("evictions",),
               "preempt": ("preemptions",),
               "trim": ("evictions", "prefix_hits")}[case]
    for name in counter:
        assert getattr(pe, name) > 0, name
    if case == "trim":
        assert pe._prefix_cache.evictable() <= 2
        assert pe._prefix_cache.evictable() == je._prefix_cache.evictable()


def test_engine_preempt_victim_is_lowest_priority_like_jax(rng):
    """(g): in a pool deadlock the older low-priority request is
    preempted, not the younger high-priority one, in both engines."""
    je, pe = _engines(num_slots=2, page_size=8, max_len=24, prefill_len=8,
                      num_pages=4)
    p0 = rng.randint(0, 512, (7,)).astype(np.int32)
    p1 = rng.randint(0, 512, (7,)).astype(np.int32)
    for eng in (je, pe):
        eng.submit(p0, max_new=12, priority=0)
        eng.submit(p1, max_new=12, priority=5)
        eng.drain()
    je.close()
    assert pe.requests[0].preemptions >= 1
    assert pe.requests[1].preemptions == 0
    for rid in (0, 1):
        assert pe.requests[rid].preemptions == je.requests[rid].preemptions
        np.testing.assert_array_equal(pe.requests[rid].output,
                                      je.requests[rid].output)


# ------------------------------------------------------- (h) recovery

def _fault_wave(rng):
    shared = rng.randint(0, 512, (8,)).astype(np.int32)
    return [np.concatenate([shared, rng.randint(0, 512, (k,)).astype(
        np.int32)]) for k in (2, 3, 11)]


@pytest.mark.parametrize("where,nth", [("serve.step", 3),
                                       ("serve.prefill", 5)])
def test_engine_recovers_from_injected_fault_like_jax(rng, fast_retry,
                                                      where, nth):
    """One injected fault (at the ``nth`` hook event or later; the
    prefill one lands on the second request's chunk after a prefix hit):
    every output is token-exact against the clean run and the JAX engine
    under the same plan, ``recoveries == 1``, and the prefix cache, which
    held entries, was cleared."""
    from paddle_tpu.testing import chaos as jchaos
    from paddle_tpu_torch.testing import chaos
    prompts = _fault_wave(rng)
    kw = dict(num_slots=2, page_size=8, max_len=32, prefill_len=8,
              num_pages=10, step_retries=3)
    _, clean = _engines(**kw)
    for p in prompts:
        clean.submit(p, max_new=8)
    clean.drain()
    assert clean.recoveries == 0
    je, pe = _engines(**kw)
    cleared = []
    real_clear = pe._prefix_cache.clear
    pe._prefix_cache.clear = lambda: (cleared.append(len(pe._prefix_cache)),
                                      real_clear())
    for p in prompts:
        je.submit(p, max_new=8)
        pe.submit(p, max_new=8)
    pattern = "^" + where.replace(".", r"\.") + "$"
    jplan = jchaos.FaultPlan(seed=0).fail("fault_point", path=pattern,
                                          nth=nth)
    with jchaos.active(jplan):
        je.drain()
    plan = chaos.FaultPlan().fail("fault_point", path=pattern, nth=nth)
    with chaos.active(plan):
        pe.drain()
    je.close()
    assert plan.fired() == jplan.fired() == 1
    assert pe.recoveries == je.recoveries == 1
    assert cleared and cleared[0] > 0 and len(cleared) == 1
    for rid in range(len(prompts)):
        np.testing.assert_array_equal(pe.requests[rid].output,
                                      clean.requests[rid].output)
        np.testing.assert_array_equal(pe.requests[rid].output,
                                      je.requests[rid].output)
        assert pe.requests[rid].recoveries == je.requests[rid].recoveries
    assert sum(r.recoveries for r in pe.requests.values()) >= 1


def test_engine_recovery_budget_exhaustion_fails_every_request(rng):
    """A decode step that always fails: after ``step_retries`` recoveries
    the engine fails every request and re-raises, with no sleep beyond
    the injected one; the same plan on the JAX engine agrees."""
    import random
    from paddle_tpu.core.retry import RetryPolicy as JPolicy
    from paddle_tpu_torch.serving import ServeConfig, ServingEngine
    from paddle_tpu_torch.testing import chaos
    _, _, pm = _shared_pair()
    sleeps = []
    eng = ServingEngine(pm, ServeConfig(
        num_slots=2, page_size=8, max_len=32, prefill_len=8,
        step_retries=2), sleep=sleeps.append)
    rids = [eng.submit(p, max_new=6) for p in _fault_wave(rng)]
    plan = chaos.FaultPlan().fail("fault_point", path=r"^serve\.step$",
                                  times=100)
    random.seed(3)
    with chaos.active(plan), pytest.raises(chaos.InjectedFault):
        eng.drain()
    assert eng.recoveries == 3 and plan.fired() == 3
    # the reference engine's budget policy, jitter drawn from the same
    # seeded random: doubling backoff from 0.05 s, each sleep jittered
    random.seed(3)
    ref = JPolicy(max_attempts=3)
    np.testing.assert_allclose(sleeps, [ref.backoff_s(1), ref.backoff_s(2)],
                               rtol=0, atol=1e-12)
    assert 0.0375 <= sleeps[0] <= 0.0625 and 0.075 <= sleeps[1] <= 0.125
    for rid in rids:
        req = eng.requests[rid]
        assert (req.status, req.retire_reason) == ("failed", "engine_error")
    assert not eng._queue and not eng._running
    assert eng._pages_available() == eng.cfg.num_pages
    # the engine serves again once the fault is gone
    prompt = _fault_wave(rng)[0]
    rid = eng.submit(prompt, max_new=6)
    eng.drain()
    clean = ServingEngine(pm, ServeConfig(
        num_slots=2, page_size=8, max_len=32, prefill_len=8))
    cid = clean.submit(prompt, max_new=6)
    clean.drain()
    assert eng.requests[rid].status == "done"
    np.testing.assert_array_equal(eng.requests[rid].output,
                                  clean.requests[cid].output)


def test_engine_recovery_drops_old_pools_before_new_ones(rng,
                                                       monkeypatch):
    """A fault raised inside the model's decode call, whose frame holds
    one of the pool tensors (as a kernel wrapper's does): by the time the
    recovery allocates the new pools no reference to an old pool tensor
    is left, so the card never holds two sets; outputs match a clean
    run."""
    import weakref
    from paddle_tpu_torch.serving import ServeConfig, ServingEngine
    _, _, pm = _shared_pair()
    kw = dict(num_slots=2, page_size=8, max_len=32, prefill_len=8)
    prompts = _fault_wave(rng)
    clean = ServingEngine(pm, ServeConfig(**kw))
    for p in prompts:
        clean.submit(p, max_new=6)
    clean.drain()
    eng = ServingEngine(pm, ServeConfig(**kw), sleep=lambda s: None)
    for p in prompts:
        eng.submit(p, max_new=6)
    old = [weakref.ref(t) for pool in eng._caches for t in pool.values()]
    real_step, real_new = pm.paged_decode_step, eng._new_caches
    fired, built = [], []

    def failing_step(tokens, caches, *args):
        if not fired:
            fired.append(1)
            held = caches[0]["k"]          # a local of the failed frame
            raise RuntimeError(f"device fault {held.shape}")
        return real_step(tokens, caches, *args)

    def new_caches():
        built.append([r for r in old if r() is not None])
        return real_new()

    monkeypatch.setattr(pm, "paged_decode_step", failing_step)
    monkeypatch.setattr(eng, "_new_caches", new_caches)
    eng.drain()
    assert eng.recoveries == 1 and built == [[]]
    for rid in clean.requests:
        np.testing.assert_array_equal(eng.requests[rid].output,
                                      clean.requests[rid].output)


def test_retry_budget_and_fault_plan_units():
    import random
    from paddle_tpu.core.retry import RetryPolicy as JPolicy
    from paddle_tpu_torch.core.retry import RetryBudget, RetryPolicy
    from paddle_tpu_torch.testing import chaos
    slept = []
    random.seed(11)
    budget = RetryBudget(RetryPolicy(max_attempts=3, backoff_s=0.1,
                                     sleep=slept.append), "unit")
    err = ValueError("x")
    assert budget.failure(err) == 1 and budget.failure(err) == 2
    with pytest.raises(ValueError):
        budget.failure(err)
    budget.success()
    random.seed(11)                   # the reference's jittered sleeps
    ref = JPolicy(max_attempts=3, backoff_base_s=0.1, jitter=0.25)
    want = [ref.backoff_s(1), ref.backoff_s(2)]
    assert budget.failures == 0 and len(slept) == 2
    np.testing.assert_allclose(slept, want, rtol=0, atol=1e-12)
    assert slept != [0.1, 0.2]
    plan = chaos.FaultPlan().fail("fault_point", path="^a$", nth=2, times=2)
    chaos.fault_point("a")                      # no plan active: free
    with chaos.active(plan):
        chaos.fault_point("a")                  # event 1 < nth
        chaos.fault_point("b")                  # event 2, path misses
        for _ in range(2):
            with pytest.raises(chaos.InjectedFault):
                chaos.fault_point("a")
        chaos.fault_point("a")                  # budget spent
    assert plan.fired() == 2 and plan.fired("other") == 0
    chaos.fault_point("a")                      # the plan left with the
    assert plan.fired() == 2                    # with-block


def test_engine_prefix_cache_fault_degrades_to_miss(rng, fast_retry):
    """A ``serve.prefix_cache`` fault makes that admission a miss:
    private pages, no recovery, outputs unchanged, like JAX."""
    from paddle_tpu.testing import chaos as jchaos
    from paddle_tpu_torch.testing import chaos
    kw, reqs = _wave("hits", rng)
    je, pe = _engines(**kw)
    for prompt, mn, _ in reqs:
        je.submit(prompt, max_new=mn)
        pe.submit(prompt, max_new=mn)
    pattern = r"^serve\.prefix_cache$"
    with jchaos.active(jchaos.FaultPlan().fail("fault_point", path=pattern,
                                               nth=2)):
        je.drain()
    plan = chaos.FaultPlan().fail("fault_point", path=pattern, nth=2)
    with chaos.active(plan):
        pe.drain()
    je.close()
    assert plan.fired() == 1 and pe.recoveries == 0
    assert pe.prefill_tokens_skipped == je.prefill_tokens_skipped
    for rid in pe.requests:
        np.testing.assert_array_equal(pe.requests[rid].output,
                                      je.requests[rid].output)


# ----------------------------------------- (i) bounded admission, cancel

class _Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def test_engine_deadlines_queue_limit_and_cancel_match_jax(rng):
    """Rejections (queue full, infeasible deadline), a deadline shed,
    and cancellation of a queued and a running request give the JAX
    engine's statuses and reasons, on a driven clock."""
    kw = dict(num_slots=1, page_size=8, max_len=24, prefill_len=8,
              queue_limit=4)
    je, pe = _engines(**kw)
    je._clock, pe._clock = _Clock(), _Clock()
    prompts = [rng.randint(0, 512, (n,)).astype(np.int32)
               for n in (5, 4, 6, 3, 4)]
    for eng in (je, pe):
        eng.submit(prompts[0], max_new=6)                  # 0: cancelled
        eng.submit(prompts[1], max_new=4, deadline_s=1.0,  # 1: shed
                   priority=-1)
        eng.submit(prompts[2], max_new=3)                  # 2: cancelled
        eng.submit(prompts[3], max_new=3)                  # 3: done
        eng.submit(prompts[4], max_new=3)                  # 4: queue full
        eng.submit(prompts[3], max_new=3, deadline_s=0.0)  # 5: infeasible
        eng.step()                                         # 0 running
        eng._clock.t += 5.0
        assert eng.cancel(2)                               # queued
        assert not eng.cancel(2) and not eng.cancel(999)
        eng.step()                                         # 1 shed
        assert eng.requests[0].status == "running"
        assert eng.cancel(0)                               # running
        assert eng._pages_available() == eng.cfg.num_pages
        eng.submit(prompts[4], max_new=2, priority=3)      # 6: done
        eng.drain()
    je.close()
    assert sorted(pe.requests) == sorted(je.requests)
    for rid in je.requests:
        j, p = je.requests[rid], pe.requests[rid]
        assert (p.status, p.retire_reason, p.retriable) == (
            j.status, j.retire_reason, j.retriable), rid
        if p.status == "done":
            np.testing.assert_array_equal(p.output, j.output)
    assert [pe.requests[r].status for r in sorted(pe.requests)] == [
        "cancelled", "shed", "cancelled", "done", "rejected", "rejected",
        "done"]
    assert pe.requests[1].retire_reason == "deadline_expired"
    assert pe.requests[4].retire_reason == "queue_full"
    assert pe.requests[5].retire_reason == "infeasible_deadline"


def test_engine_default_deadline_matches_jax(rng):
    """``default_deadline_s`` > 0: a request submitted without a deadline
    gets the default one and is shed past it; an explicit deadline wins.
    Statuses, reasons and deadlines equal the JAX engine's."""
    kw = dict(num_slots=1, page_size=8, max_len=24, prefill_len=8,
              default_deadline_s=2.0)
    je, pe = _engines(**kw)
    je._clock, pe._clock = _Clock(), _Clock()
    prompts = [rng.randint(0, 512, (n,)).astype(np.int32)
               for n in (5, 4, 6, 3)]
    for eng in (je, pe):
        eng.submit(prompts[0], max_new=4)                  # 0: done
        eng.submit(prompts[1], max_new=3)                  # 1: shed
        eng.submit(prompts[2], max_new=3, deadline_s=50)   # 2: done
        eng.submit(prompts[3], max_new=3)                  # 3: shed
        eng.step()
        eng._clock.t += 5.0
        eng.drain()
    je.close()
    for rid in je.requests:
        j, p = je.requests[rid], pe.requests[rid]
        assert (p.status, p.retire_reason, p.deadline_t) == (
            j.status, j.retire_reason, j.deadline_t), rid
        if p.status == "done":
            np.testing.assert_array_equal(p.output, j.output)
    assert [pe.requests[r].status for r in range(4)] == [
        "done", "shed", "done", "shed"]
    assert pe.requests[1].deadline_t == 102.0
    assert pe.requests[2].deadline_t == 150.0


def test_engine_config_sampling_defaults_match_jax(rng):
    """The config's ``temperature`` / ``top_k`` / ``top_p`` / ``seed``:
    a request without knobs takes the config's, an explicit knob wins,
    and a missing seed derives from ``cfg.seed`` and the id, as in the
    JAX engine. A request on the config's knobs draws the tokens of the
    same knobs given explicitly, and ``cfg.seed`` keys the stream."""
    from paddle_tpu_torch.serving import ServeConfig, ServingEngine
    knobs = dict(temperature=0.9, top_k=40, top_p=0.95, seed=5)
    base = dict(num_slots=2, page_size=8, max_len=32, prefill_len=8)
    je, pe = _engines(**base, **knobs)
    prompt = rng.randint(0, 512, (9,)).astype(np.int32)
    for eng in (je, pe):
        eng.submit(prompt, max_new=12)                     # 0: config's
        eng.submit(prompt, max_new=12, top_k=3, seed=11)   # 1: overrides
        eng.submit(prompt, max_new=12, temperature=0.0)    # 2: greedy
    je.close()
    for rid in range(3):
        j, p = je.requests[rid], pe.requests[rid]
        assert (p.temperature, p.top_k, p.top_p, p.seed) == pytest.approx(
            (j.temperature, j.top_k, j.top_p, int(j.seed))), rid
    assert pe.requests[1].top_k == 3 and pe.requests[1].seed == 11
    pe.drain()
    _, _, pm = _shared_pair()

    def explicit(cfg_seed, req_seed):
        eng = ServingEngine(pm, ServeConfig(**base, seed=cfg_seed))
        rid = eng.submit(prompt, max_new=12, temperature=0.9, top_k=40,
                         top_p=0.95, seed=req_seed)
        eng.drain()
        return eng.requests[rid].tokens

    derived = pe.requests[0].seed
    assert pe.requests[0].tokens == explicit(5, derived)
    assert pe.requests[0].tokens != explicit(6, derived)


def test_shed_queued_sheds_lowest_priority_like_jax(rng):
    kw = dict(num_slots=1, page_size=8, max_len=24, prefill_len=8)
    je, pe = _engines(**kw)
    prompts = [rng.randint(0, 512, (4,)).astype(np.int32) for _ in range(4)]
    out = []
    for eng in (je, pe):
        for p, prio in zip(prompts, (5, 5, 1, 5)):
            eng.submit(p, max_new=3, priority=prio)
        eng.step()
        out.append(eng.shed_queued())
        eng.drain()
    je.close()
    assert out[0] == out[1] == [2]
    assert pe.requests[2].status == "shed"
    assert pe.requests[2].retire_reason == "overload"
    assert all(pe.requests[r].status == "done" for r in (0, 1, 3))
