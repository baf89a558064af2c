"""The port's fleet router against the JAX package's: both routers serve
the same prompt stream with the same scenario on GPTConfig.tiny() (dropout
0, the JAX weights carried over by the bridge), each on one settable
clock shared with its heartbeat monitor, and must agree exactly on each
request's status, retirement reason, greedy tokens and finishing replica,
on ``failovers``, the ``fleet.*`` counters, ``telemetry()``'s states,
roles, versions and ``version_stats``, and on the kinds of ``ops_log`` in
order. Scenarios here: the plain stream with a shared page-sized prefix
(affinity), a replica killed mid-stream, a heartbeat stall then death by
the clock, ``drain`` with a late submission, prefill/decode
disaggregation with prompts longer than ``prefill_len``, and the admission
limit beside a replica queue bound of one under injected dispatch faults;
the rolling deploy, the canary and the autoscaler are in
test_torch_fleet_ops.py. The engine hooks the router drives (``adopt``,
``export_inflight``, ``prefix_lookup_depth``) are held against the JAX
engine's on a fake clock. Greedy tokens are held exactly, and against one
engine serving the same prompts alone where the scenario says so.
"""

import numpy as np
import pytest
import torch

import jax

from paddle_tpu.core.flags import all_flags, set_flags

torch.set_num_threads(1)

SERVE = dict(num_slots=2, page_size=8, max_len=64, prefill_len=16)

#: the fleet counters each scenario compares (deltas over the scenario)
FLEET_COUNTERS = ("fleet.affinity_hits", "fleet.rerouted",
                  "fleet.respawns", "fleet.deploys", "fleet.canary_aborts",
                  "fleet.handoffs", "fleet.scale_events", "fleet.failovers",
                  "fleet.version_retirements")


@pytest.fixture
def fast_retry():
    """Respawn backoff of a millisecond on the JAX side (the port's
    router sleeps through an injected no-op)."""
    saved = all_flags()
    set_flags({"retry_backoff_base_s": 0.001, "retry_jitter": 0.0})
    yield
    set_flags(saved)


_PAIRS = {}


def pair(seed=0):
    """(JAX model, JAX variables, port decoder) with the same weights,
    built once per seed."""
    if seed not in _PAIRS:
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
        bridge.load_params(pm, jax.tree_util.tree_map(np.asarray,
                                                      v["params"]))
        _PAIRS[seed] = (jm, v, pm)
    return _PAIRS[seed]


class Side:
    """One package's half of a comparison: its modules, its router and
    the router's settable clock."""

    def __init__(self, name, fleet_kw, serve_kw):
        self.name = name
        jm, v, pm = pair(0)
        if name == "jax":
            from paddle_tpu.io import checkpoint
            from paddle_tpu.observability import metrics
            from paddle_tpu.serving import (DeployAborted, FleetConfig,
                                            FleetRouter, ServeConfig)
            from paddle_tpu.testing import chaos
            self.router = FleetRouter(
                jm, v, FleetConfig(metrics_port=0, **fleet_kw),
                serve_config=ServeConfig(metrics_port=0, **serve_kw))
        else:
            from paddle_tpu_torch.io import checkpoint
            from paddle_tpu_torch.observability import metrics
            from paddle_tpu_torch.serving import (DeployAborted,
                                                  FleetConfig, FleetRouter,
                                                  ServeConfig)
            from paddle_tpu_torch.testing import chaos
            self.router = FleetRouter(
                pm, FleetConfig(**fleet_kw),
                serve_config=ServeConfig(**serve_kw),
                sleep=lambda s: None)
        self.checkpoint, self.metrics, self.chaos = checkpoint, metrics, chaos
        self.DeployAborted = DeployAborted
        self.clk = {"t": 100.0}
        r = self.router
        r._clock = lambda: self.clk["t"]
        r._monitor._clock = r._clock
        for i in range(len(r._replicas)):
            r._monitor.update(i)
        self._base = self.counters()

    def weights(self, seed):
        """The weights of ``pair(seed)`` in this side's deploy form: the
        JAX variables tree, or the port decoder."""
        jm, v, pm = pair(seed)
        return v if self.name == "jax" else pm

    def counters(self):
        return {k: dict(self.metrics.counter(k).snapshot())
                for k in FLEET_COUNTERS}

    def counter_deltas(self):
        now = self.counters()
        return {k: {lab: n - self._base[k].get(lab, 0)
                    for lab, n in now[k].items()
                    if n != self._base[k].get(lab, 0)}
                for k in FLEET_COUNTERS}

    def summary(self, fids):
        r = self.router
        tel = r.telemetry()
        return dict(
            requests=[(r.requests[f].status, r.requests[f].retire_reason,
                       list(r.requests[f].tokens), r.requests[f].replica,
                       r.requests[f].version, r.requests[f].reroutes)
                      for f in fids],
            failovers=r.failovers, handoffs=tel["handoffs"],
            states=tel["states"], roles=tel["roles"],
            versions=tel["versions"],
            baseline=tel["baseline_version"],
            canary=tel["canary_version"],
            version_stats=tel["version_stats"],
            ops=[e["event"] for e in tel["ops_log"]],
            counters=self.counter_deltas())


def prompts_of(n, seed, lo=3, hi=30, prefix=0, vocab=512):
    """``n`` prompts of lengths in [lo, hi); with ``prefix``, every other
    one opens with the same ``prefix`` tokens (a full page)."""
    rs = np.random.RandomState(seed)
    head = rs.randint(0, vocab, prefix).astype(np.int32)
    out = []
    for i in range(n):
        p = rs.randint(0, vocab, int(rs.randint(lo, hi))).astype(np.int32)
        out.append(np.concatenate([head, p]) if prefix and i % 2 == 0
                   else p)
    return out


def compare(scenario, fleet_kw, serve_kw=None):
    """Run ``scenario(side) -> fids`` on both packages' routers; the
    summaries must be equal. Returns the port's side and summary."""
    serve_kw = dict(SERVE, **(serve_kw or {}))
    fleet_kw = dict(dict(heartbeat_s=5.0), **fleet_kw)
    out = {}
    for name in ("jax", "port"):
        side = Side(name, fleet_kw, serve_kw)
        fids = scenario(side)
        out[name] = (side, side.summary(fids))
        side.router.close()
    want, got = out["jax"][1], out["port"][1]
    for key in want:
        assert got[key] == want[key], (key, got[key], want[key])
    return out["port"]


def alone(prompts, max_new, serve_kw=None):
    """Each prompt's tokens from one port engine serving the prompts."""
    from paddle_tpu_torch.serving import ServeConfig, ServingEngine
    eng = ServingEngine(pair(0)[2], ServeConfig(**dict(SERVE,
                                                       **(serve_kw or {}))))
    rids = [eng.submit(p, max_new=max_new) for p in prompts]
    eng.drain()
    return [eng.requests[r].tokens for r in rids]


# ------------------------------------------------------------- scenarios

def plain(side):
    """Half the prompts share a page; the second wave arrives after the
    first admitted, so affinity has warm caches to route to."""
    ps = prompts_of(10, seed=3, prefix=8)
    fids = [side.router.submit(p, max_new=6) for p in ps[:4]]
    for _ in range(3):
        side.router.step()
    fids += [side.router.submit(p, max_new=6) for p in ps[4:]]
    side.router.drain()
    return fids


def kill(side):
    r = side.router
    fids = [r.submit(p, max_new=8) for p in prompts_of(6, seed=1)]
    for _ in range(2):
        r.step()
    victim = max(range(len(r._replicas)), key=lambda i: r._replicas[i].load())
    r.kill_replica(victim)
    r.drain()
    return fids


def heartbeat(side):
    """A dropped ping stalls replica 0 (no dispatch to it), then every
    ping drops past the dead mark: a failover by the clock alone."""
    r, clk = side.router, side.clk
    fids = [r.submit(p, max_new=6) for p in prompts_of(4, seed=5)]
    r.step()
    plan = side.chaos.FaultPlan().fail(
        "fault_point", path=r"^fleet\.heartbeat$", times=1)
    with side.chaos.active(plan):
        clk["t"] += 1.5
        r.step()
    assert r._states == ["stalled", "live"]
    fids.append(r.submit(prompts_of(1, seed=6)[0], max_new=4))
    assert r.requests[fids[-1]].replica == 1
    plan = side.chaos.FaultPlan().fail(
        "fault_point", path=r"^fleet\.heartbeat$", times=100)
    with side.chaos.active(plan):
        clk["t"] += 4.0
        r.step()
    assert r.failovers >= 1
    clk["t"] += 0.1
    r.drain()
    return fids


def drain(side):
    r = side.router
    fids = [r.submit(p, max_new=5, priority=i % 3)
            for i, p in enumerate(prompts_of(5, seed=9))]
    r.step()
    r.drain()
    late = r.submit(prompts_of(1, seed=10)[0], max_new=4)
    assert r.requests[late].retriable
    return fids + [late]


LONG = dict(max_len=64, prefill_len=16)


def disagg(side):
    """Prompts of 17-40 tokens (past prefill_len) alternate with short
    ones: the long ones prefill on replica 0 and hand off."""
    r = side.router
    ps = prompts_of(6, seed=11, lo=17, hi=40)
    ps = [p if i % 2 == 0 else p[:6] for i, p in enumerate(ps)]
    fids = [r.submit(p, max_new=8) for p in ps]
    r.drain()
    return fids


def test_plain_stream_matches_jax(fast_retry):
    side, s = compare(plain, dict(num_replicas=3))
    assert all(q[0] == "done" for q in s["requests"])
    assert s["counters"]["fleet.affinity_hits"]
    assert [q[2] for q in s["requests"]] == alone(
        prompts_of(10, seed=3, prefix=8), 6)


def test_kill_mid_stream_matches_jax_and_is_token_exact(fast_retry):
    side, s = compare(kill, dict(num_replicas=2))
    assert s["failovers"] == 1 and any(q[5] for q in s["requests"])
    assert [q[2] for q in s["requests"]] == alone(prompts_of(6, seed=1), 8)


def test_heartbeat_stall_and_death_match_jax(fast_retry):
    side, s = compare(heartbeat, dict(num_replicas=2, heartbeat_s=1.0,
                                      heartbeat_dead_factor=3.0))
    assert s["failovers"] >= 1
    assert all(q[0] == "done" for q in s["requests"])


def test_drain_matches_jax(fast_retry):
    side, s = compare(drain, dict(num_replicas=2))
    assert [q[0] for q in s["requests"]] == ["done"] * 5 + ["rejected"]
    assert s["requests"][-1][1] == "draining"


def test_disaggregated_handoffs_match_jax_and_are_token_exact(fast_retry):
    side, s = compare(disagg, dict(num_replicas=3, prefill_replicas=1),
                      serve_kw=LONG)
    assert s["roles"] == ["prefill", "decode", "decode"]
    assert s["handoffs"] == 3
    ps = prompts_of(6, seed=11, lo=17, hi=40)
    ps = [p if i % 2 == 0 else p[:6] for i, p in enumerate(ps)]
    assert [q[2] for q in s["requests"]] == alone(ps, 8, LONG)
    assert all(q[3] != 0 for q in s["requests"])    # finished on decode


def admission(side):
    """One decode slot a replica and a queue bound of one keep work
    router-pending; past three outstanding the admission limit rejects
    (retriable) instead of queueing; two injected fleet.dispatch faults
    delay a pending request and lose none."""
    r = side.router
    plan = side.chaos.FaultPlan().fail(
        "fault_point", path=r"^fleet\.dispatch$", times=2)
    with side.chaos.active(plan):
        fids = [r.submit(p, max_new=4)
                for p in prompts_of(6, seed=7, lo=3, hi=10)]
        assert [r.requests[f].status for f in fids].count("pending") >= 1
        r.drain()
    assert plan.fired("fault_point") == 2
    assert all(r.requests[f].retriable for f in fids
               if r.requests[f].status == "rejected")
    return fids


def test_admission_and_queue_limits_match_jax(fast_retry):
    side, s = compare(admission, dict(num_replicas=2, admission_limit=3,
                                      replica_queue_limit=1),
                      serve_kw=dict(num_slots=1))
    assert side.router.cfg.replica_queue_limit == 1
    assert [(q[0], q[1]) for q in s["requests"]] == (
        [("done", "length")] * 3
        + [("rejected", "fleet_admission_limit")] * 3)


# ------------------------------------------------------------ engine hooks

class Clock:
    """Advances 1 ms on every read."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        self.t += 1e-3
        return self.t


def _hooks(side_name):
    """Submit, adopt (fresh, mid-stream with kept times and a trace
    context, and a replay long enough for two chunks), then read
    ``export_inflight`` after one step, ``prefix_lookup_depth`` of
    several prompts, and every request after a drain."""
    jm, v, pm = pair(0)
    if side_name == "jax":
        from paddle_tpu.serving import ServeConfig, ServingEngine
        eng = ServingEngine(jm, v, ServeConfig(metrics_port=0, **SERVE),
                            clock=Clock())
    else:
        from paddle_tpu_torch.serving import ServeConfig, ServingEngine
        eng = ServingEngine(pm, ServeConfig(**SERVE), clock=Clock())
    ps = prompts_of(4, seed=21, prefix=16)
    eng.submit(ps[0], max_new=5)
    eng.adopt(ps[1], max_new=6, priority=2)
    eng.adopt(ps[2], tokens=[7, 8, 9], max_new=7, submit_t=0.5,
              first_token_t=0.75, deadline_t=99.0, seed=4,
              trace={"trace_id": "run/3", "span_id": "hop1",
                     "parent_span_id": "hop0"}, origin="failover")
    eng.adopt(np.concatenate([ps[3], ps[3]]), tokens=[1], max_new=4)
    eng.step()
    inflight = eng.export_inflight()
    depths = [eng.prefix_lookup_depth(p) for p in ps]
    eng.drain()
    reqs = [(r.status, r.tokens, r.submit_t, r.first_token_t, r.deadline_t,
             r.trace_id if r.id == 2 else None, r.span_id,
             r.parent_span_id, [e for e, _ in r.trace])
            for r in eng.requests.values()]
    return inflight, depths, reqs


def test_engine_hooks_match_jax():
    want, got = _hooks("jax"), _hooks("port")
    assert got[0] == want[0]
    assert got[1] == want[1] and max(got[1]) > 0
    assert got[2] == want[2]
    assert got[2][2][2:5] == (0.5, 0.75, 99.0)
    assert got[2][2][5:8] == ("run/3", "hop1", "hop0")


def test_chunked_prefill_off_refuses_long_prompts():
    """``chunked_prefill=False`` refuses a prompt past ``prefill_len`` on
    submit and on adopt, as the JAX engine does."""
    from paddle_tpu.serving import ServeConfig as JServe
    from paddle_tpu.serving import ServingEngine as JEngine
    from paddle_tpu_torch.core.enforce import EnforceError
    from paddle_tpu_torch.serving import ServeConfig, ServingEngine
    jm, v, pm = pair(0)
    je = JEngine(jm, v, JServe(metrics_port=0, chunked_prefill=False,
                               **SERVE))
    pe = ServingEngine(pm, ServeConfig(chunked_prefill=False, **SERVE))
    long = prompts_of(1, seed=2, lo=20, hi=21)[0]
    for eng, err in ((je, Exception), (pe, EnforceError)):
        with pytest.raises(err):
            eng.submit(long, max_new=4)
        with pytest.raises(err):
            eng.adopt(long, max_new=4)
        eng.submit(long[:16], max_new=4)
        eng.drain()
    assert pe.requests[0].tokens == je.requests[0].tokens


def test_fleet_stays_on_its_device_and_fails_over_engine_errors():
    """Every replica's engine is built on the baseline module's device
    and a module on another device is refused at deploy; an engine whose
    step keeps failing past its recovery budget dies, and the router
    fails its work over to a respawned replica (no plain version)."""
    import copy

    from paddle_tpu_torch.core.enforce import EnforceError
    from paddle_tpu_torch.serving import (FleetConfig, FleetRouter,
                                          ServeConfig)
    from paddle_tpu_torch.testing import chaos
    _, _, pm = pair(0)
    r = FleetRouter(pm, FleetConfig(num_replicas=2),
                    serve_config=ServeConfig(**SERVE),
                    sleep=lambda s: None)
    other = copy.deepcopy(pm).to("meta")
    with pytest.raises(EnforceError):
        r.deploy(other, version="v1")
    assert {h.engine._device for h in r._replicas} == {pm.device}
    r.close()
    r = FleetRouter(pm, FleetConfig(num_replicas=1),
                    serve_config=ServeConfig(**SERVE),
                    sleep=lambda s: None)
    ps = prompts_of(4, seed=12)
    fids = [r.submit(p, max_new=6) for p in ps]
    plan = chaos.FaultPlan().fail("fault_point", path=r"^serve\.step$",
                                  times=4)
    with chaos.active(plan):
        r.drain()
    assert plan.fired() == 4 and r.failovers == 1
    assert [r.requests[f].status for f in fids] == ["done"] * 4
    assert [r.requests[f].tokens for f in fids] == alone(ps, 6)
    assert {h.engine._device for h in r._replicas} == {pm.device}
    r.close()


def test_concurrent_submit_cancel_step_and_scrapes():
    """Client threads submit and cancel while the round loop steps and a
    scraper reads telemetry and renders /metrics (a short switch
    interval, more threads than this test's one core): every request
    reaches a terminal status, every thread exits clean and nothing
    deadlocks between the router's, the engines' and the registry's
    locks."""
    import sys
    import threading
    import time

    from paddle_tpu_torch.observability.exporter import render_prometheus
    from paddle_tpu_torch.serving import (FleetConfig, FleetRouter,
                                          ServeConfig)
    r = FleetRouter(pair(0)[2], FleetConfig(num_replicas=2),
                    serve_config=ServeConfig(**SERVE),
                    sleep=lambda s: None)
    errors, fids = [], []
    lock, stop = threading.Lock(), threading.Event()

    def client(seed):
        try:
            for i, p in enumerate(prompts_of(4, seed=seed, hi=12)):
                fid = r.submit(p, max_new=4)
                with lock:
                    fids.append(fid)
                if i == 1:
                    r.cancel(fid)
                time.sleep(0.001)
        except Exception as e:
            errors.append(("client", seed, repr(e)))

    def scraper():
        try:
            while not stop.is_set():
                r.telemetry()
                r.goodput()
                render_prometheus()
        except Exception as e:
            errors.append(("scraper", repr(e)))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    threads = [threading.Thread(target=client, args=(60 + i,))
               for i in range(4)] + [threading.Thread(target=scraper)]
    try:
        for t in threads:
            t.start()
        deadline = time.monotonic() + 120
        while any(t.is_alive() for t in threads[:-1]) or any(
                q.status in ("pending", "dispatched")
                for q in list(r.requests.values())):
            r.step()
            assert time.monotonic() < deadline, "hammer wedged"
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=30)
        sys.setswitchinterval(old)
        r.close()
    assert not any(t.is_alive() for t in threads)
    assert errors == [] and len(fids) == 16
    statuses = [r.requests[f].status for f in fids]
    assert set(statuses) <= {"done", "cancelled"}
    assert statuses.count("done") >= 12
