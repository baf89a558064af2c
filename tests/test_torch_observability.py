"""The port's observability modules and the engine's accounting against the
JAX package: ``observability/metrics.py`` and ``runlog.py`` fed the same
inputs as the JAX modules, and the serving engine's ``serve.*`` metrics,
``latency_stats()``, ``slo_stats()``, ``goodput()`` and run log against
the JAX engine's on a fake clock (every clock read advances it by 1 ms,
so equal readings need equal reads in the same order). Everything is
held exactly: both sides compute the same floats in the same order.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax

torch.set_num_threads(1)


# ------------------------------------------------------ (a) the registry

def _registry_script(mod):
    """One scripted use of every registry method; returns what it read."""
    reg = mod.MetricsRegistry()
    out = []
    c = reg.counter("serve.requests", help="h")
    c.inc(status="submitted")
    c.inc(3, status="done")
    c.inc(2, status="done", zone="a,b=c")      # a comma inside a value
    out += [c.value(status="done"), c.total(), c.snapshot()]
    g = reg.gauge("serve.queue_depth")
    g.set(4)
    g.set(7, slot=1)
    out += [g.value(), g.value(slot=1), g.value(slot=9)]
    h = reg.histogram("serve.ttft_s", max_samples=64)
    rs = np.random.RandomState(0)
    for x in rs.exponential(0.05, 3000):         # past the reservoir
        h.observe(float(x))
    for x in (0.5, 0.25, 0.125):
        h.observe(x, kind="short")
    out += [h.count(), h.percentile(0.5), h.percentile(0.99, kind="short"),
            h.stats(), h.stats(kind="short"), h.stats(kind="none")]
    with pytest.raises(ValueError):
        reg.gauge("serve.requests")                # a counter already
    out += [reg.names(), reg.get("serve.ttft_s") is h, reg.snapshot()]
    out.append([mod.parse_label_key(k) for k in c.snapshot()])
    reg.reset()
    out += [reg.snapshot(), reg.names(), h.count()]
    return out


def test_metrics_registry_matches_jax():
    """Counters, gauges and histograms (reservoir sampling past
    ``max_samples``, percentiles, stats with ``dropped``), label keys
    (values with commas), the kind check, snapshots and reset give
    identical results in both modules."""
    from paddle_tpu.observability import metrics as jm
    from paddle_tpu_torch.observability import metrics as pm
    want, got = _registry_script(jm), _registry_script(pm)
    assert got == want
    assert got[6] == 3000 and got[9]["dropped"] == 3000 - 64


def test_global_registry_helpers_match_jax():
    """The process-global helpers and ``reset_all`` behave alike (names
    private to this test, so other metrics are left alone)."""
    from paddle_tpu.observability import metrics as jm
    from paddle_tpu_torch.observability import metrics as pm
    for mod in (jm, pm):
        mod.counter("test.obs_c").inc(5, k="v")
        mod.gauge("test.obs_g").set(2.5)
        mod.histogram("test.obs_h").observe(1.0)
    js, ps = jm.snapshot(), pm.snapshot()
    for sec, name in (("counters", "test.obs_c"), ("gauges", "test.obs_g"),
                      ("histograms", "test.obs_h")):
        assert ps[sec][name] == js[sec][name]
    assert pm.registry() is pm.registry()


# ------------------------------------------------------- (b) the run log

def _runlog_script(mod, root):
    log = mod.RunLog(os.path.join(root, "run.jsonl"), rotate_records=3,
                     keep_rotated=2)
    with log:
        for i in range(10):
            log.write({"step": i, "wall_s": i / 8})
    path = log.path
    with open(path, "a") as f:
        f.write('{"step": 99, "torn')            # a killed writer's tail
    with open(path + ".2bak", "w") as f:          # not a rotation
        f.write("{}\n")
    files = sorted(os.listdir(root))
    return [files, mod.read_records(path), mod.tail_records(path, 2),
            mod.tail_records(path, 0),
            mod.read_records(os.path.join(root, "missing.jsonl"))]


def test_runlog_rotation_and_reads_match_jax(tmp_path):
    """Rotation (3 records a file, 2 rotated files kept), a torn last
    line, a sibling whose suffix is not a number, ``read_records`` and
    ``tail_records``: identical in both modules."""
    from paddle_tpu.observability import runlog as jr
    from paddle_tpu_torch.observability import runlog as pr
    (tmp_path / "j").mkdir()
    (tmp_path / "p").mkdir()
    want = _runlog_script(jr, str(tmp_path / "j"))
    got = _runlog_script(pr, str(tmp_path / "p"))
    assert got == want
    assert [r["step"] for r in got[1]] == [3, 4, 5, 6, 7, 8, 9]


# ------------------------------------------ (c) the engine's accounting

class Clock:
    """Each read advances the time by 1 ms."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        self.t += 1e-3
        return self.t


_CACHE = {}


def _models():
    if not _CACHE:
        from paddle_tpu.models.gpt import GPTConfig, GPTDecoder
        from paddle_tpu_torch import bridge
        from paddle_tpu_torch.models.gpt import GPTConfig as PConfig
        from paddle_tpu_torch.models.gpt import GPTDecoder as PDecoder
        cfg = GPTConfig.tiny()
        cfg.dropout = 0.0
        jm = GPTDecoder(cfg)
        v = jm.init(jax.random.key(5))
        pcfg = PConfig.tiny()
        pcfg.dropout = 0.0
        pm = PDecoder(pcfg, device="cpu", seed=7).eval()
        bridge.load_params(pm, jax.tree_util.tree_map(np.asarray,
                                                      v["params"]))
        _CACHE["m"] = (jm, v, pm)
    return _CACHE["m"]


SERVE = dict(num_slots=2, page_size=8, max_len=40, prefill_len=16,
             num_pages=5, draft=True, spec_k=3, slo_ttft_s=0.02,
             slo_token_latency_s=0.0015, model_version="tiny@1")


def _wave(rng):
    return [rng.randint(0, 512, (n,)).astype(np.int32)
            for n in (5, 21, 9, 14, 3)]


def _drive(eng, prompts):
    for i, p in enumerate(prompts):
        eng.submit(p, max_new=10 + i, priority=i % 2)
    eng.cancel(eng.submit(prompts[0], max_new=4))
    eng.submit(prompts[1], max_new=4, deadline_s=0.0)     # infeasible
    eng.drain()


def _events(path):
    from paddle_tpu_torch.observability.runlog import read_records
    return [{k: v for k, v in r.items() if k != "trace"}
            for r in read_records(path) if "event" in r]


def test_engine_accounting_matches_jax_on_a_fake_clock(rng, tmp_path):
    """One speculative wave with preemptions, a cancel and a rejection,
    under SLOs that some requests miss: ``latency_stats()``,
    ``slo_stats()``, ``goodput()`` and ``spec_stats()`` equal the JAX
    engine's, as do the run log's per-step records, its lifecycle events
    (times included) and its final record's SLO section."""
    from paddle_tpu.serving import ServeConfig as JServe
    from paddle_tpu.serving import ServingEngine as JEngine
    from paddle_tpu_torch.serving import ServeConfig, ServingEngine
    jm, v, pm = _models()
    prompts = _wave(rng)
    je = JEngine(jm, v, JServe(**SERVE, run_log=str(tmp_path / "j.jsonl")),
                 clock=Clock())
    pe = ServingEngine(pm, ServeConfig(**SERVE,
                                       run_log=str(tmp_path / "p.jsonl")),
                       clock=Clock())
    for eng in (je, pe):
        eng.reset_stats()       # the histograms are process-global
        _drive(eng, prompts)
        eng.close()
    assert pe.latency_stats() == je.latency_stats()
    assert pe.slo_stats() == je.slo_stats()
    assert pe.goodput() == je.goodput()
    assert pe.spec_stats() == je.spec_stats()
    slo = pe.slo_stats()
    assert 0 < slo["violations"]["ttft"] < slo["retired"]
    assert 0 < slo["violations"]["token_latency"] < slo["retired"]
    assert pe.preemptions > 0
    assert [r.slo_ok for r in pe.requests.values()] \
        == [r.slo_ok for r in je.requests.values()]
    assert [r.trace for r in pe.requests.values()] \
        == [r.trace for r in je.requests.values()]
    from paddle_tpu_torch.observability.runlog import read_records
    jrec = read_records(str(tmp_path / "j.jsonl"))
    prec = read_records(str(tmp_path / "p.jsonl"))
    steps = [[r for r in recs if r.get("phase") == "serve"
              and "step" in r] for recs in (jrec, prec)]
    assert steps[1] == steps[0]
    assert any("spec_proposed" in r for r in steps[1])
    events = _events(str(tmp_path / "p.jsonl"))
    assert events == _events(str(tmp_path / "j.jsonl"))
    assert {e["event"] for e in events} >= {
        "submitted", "admitted", "prefill_done", "first_token",
        "preempted", "resumed", "retired"}
    assert prec[-1]["final"] and prec[-1]["slo"] == jrec[-1]["slo"]
    assert prec[-1]["kv_dtype"] == jrec[-1]["kv_dtype"] == "f32"
    json.dumps(prec)


def test_engine_metric_deltas_equal_its_counters(rng):
    """The ``serve.spec_*`` counters move by what ``spec_stats()`` counts,
    ``serve.tokens`` by the tokens emitted, ``serve.requests`` by status,
    and ``reset_stats()`` zeroes the speculation tallies and the latency
    histograms; a step of a spec-off engine reads no ``spec_*``."""
    from paddle_tpu_torch.observability import metrics
    from paddle_tpu_torch.serving import ServeConfig, ServingEngine
    _, _, pm = _models()
    names = ("serve.spec_proposed", "serve.spec_accepted",
             "serve.spec_rollbacks", "serve.tokens")
    base = {k: metrics.counter(k).total() for k in names}
    done0 = metrics.counter("serve.requests").value(status="completed")
    eng = ServingEngine(pm, ServeConfig(**dict(SERVE, num_pages=None)))
    prompts = _wave(rng)
    for p in prompts:
        eng.submit(p, max_new=8)
    eng.drain()
    delta = {k: metrics.counter(k).total() - base[k] for k in names}
    stats = eng.spec_stats()
    assert delta["serve.spec_proposed"] == stats["proposed"] > 0
    assert delta["serve.spec_accepted"] == stats["accepted"]
    assert delta["serve.spec_rollbacks"] == stats["rollbacks"]
    assert delta["serve.tokens"] == 8 * len(prompts)
    assert metrics.counter("serve.requests").value(
        status="completed") - done0 == len(prompts)
    assert eng.latency_stats()["ttft_ms"]["n"] >= len(prompts)
    eng.reset_stats()
    assert eng.spec_stats()["proposed"] == 0
    assert eng.latency_stats() == {}
    assert eng.slo_stats()["retired"] == 0 and eng.goodput() == 1.0
    off = ServingEngine(pm, ServeConfig(num_slots=2, page_size=8,
                                        max_len=40, prefill_len=16))
    before = metrics.counter("serve.spec_proposed").total()
    off.submit(prompts[0], max_new=3)
    off.drain()
    assert metrics.counter("serve.spec_proposed").total() == before
    assert off.spec_stats()["enabled"] is False
