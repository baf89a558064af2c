"""The live observability plane the fleet runs on, the port's modules
against the JAX package's on the same inputs: the metric catalog (names,
kinds, labels, help), ``render_prometheus`` (the same text from the same
registry contents) and the ``/metrics`` server, ``HeartBeatMonitor``'s
state sequence on a fake clock (``FileHeartbeat`` and the file barrier
beside it), the watchdog's anomalies on one tick stream, trace contexts
and ``merge_fleet_trace``, and the flight recorder's bundle (manifest
keys, files, ring). Then the plane wired into the engines: a standalone
engine's watchdog sheds and dumps as the JAX engine's does, a replica's
anomaly reaches the router's flight bundle, and the router's single
exporter serves the fleet's gauges. Everything is held exactly."""

import json
import os
import socket
import urllib.request

import numpy as np
import pytest
import torch

from paddle_tpu.core.flags import all_flags, set_flags

torch.set_num_threads(1)


def _mods(pkg):
    import importlib
    return {name: importlib.import_module(f"{pkg}.observability.{name}")
            for name in ("catalog", "exporter", "flight", "metrics",
                         "trace", "watchdog", "runlog")}


@pytest.fixture(scope="module")
def both():
    return {"jax": _mods("paddle_tpu"), "port": _mods("paddle_tpu_torch")}


class FakeClock:
    def __init__(self, t=10.0):
        self.t = t

    def __call__(self):
        return self.t


class ListLog:
    """A RunLog stand-in that keeps what it is handed."""

    def __init__(self):
        self.records = []
        self.path = None

    def write(self, rec):
        self.records.append(dict(rec))


# ---------------------------------------------------------------- catalog

def test_catalog_matches_jax(both):
    jc, pc = both["jax"]["catalog"], both["port"]["catalog"]
    assert {k: tuple(v) for k, v in pc.CATALOG.items()} \
        == {k: tuple(v) for k, v in jc.CATALOG.items()}
    for name in ("fleet.handoffs", "span.serve.step", "serve.tokens",
                 "nope.metric"):
        assert pc.help_for(name) == jc.help_for(name)
        assert (pc.lookup(name) is None) == (jc.lookup(name) is None)
    regs = {}
    for side, mods in both.items():
        reg = mods["metrics"].MetricsRegistry()
        made = mods["catalog"].preregister(
            ["fleet.replicas", "serve.ttft_s", "fleet.failovers"], reg)
        regs[side] = [(m.name, m.kind, m.help) for m in made]
        with pytest.raises(KeyError):
            mods["catalog"].preregister(["not.cataloged"], reg)
    assert regs["port"] == regs["jax"]


# --------------------------------------------------------------- exporter

def _feed(metrics):
    reg = metrics.MetricsRegistry()
    c = reg.counter("fleet.deploys")
    c.inc(status="ok")
    c.inc(2, status='ab"c\\d\ne')            # escaped label value
    c.inc(3, status="x,y=z")                  # a comma inside a value
    reg.gauge("fleet.replicas").set(3, state="live")
    reg.gauge("fleet.replicas").set(0.25, state="dead")
    reg.gauge("test.plane_gauge", help="own help").set(1e16)
    h = reg.histogram("serve.ttft_s", max_samples=16)
    rs = np.random.RandomState(0)
    for x in rs.exponential(0.05, 100):
        h.observe(float(x))
    h.observe(0.5, kind="short")
    reg.counter("9bad-name.x")                # registered, no samples
    return reg


def test_render_prometheus_matches_jax(both):
    texts = {side: mods["exporter"].render_prometheus(_feed(mods["metrics"]))
             for side, mods in both.items()}
    assert texts["port"] == texts["jax"]
    assert '# TYPE serve_ttft_s summary' in texts["port"]
    assert 'status="ab\\"c\\\\d\\ne"' in texts["port"]
    for v in ('prom_name', 'escape_label_value'):
        fj, fp = getattr(both["jax"]["exporter"], v), \
            getattr(both["port"]["exporter"], v)
        for s in ("serve.tokens", "9x", "", 'a"b\\c\n'):
            assert fp(s) == fj(s)


def test_metrics_server_serves_the_registry(both):
    ex = both["port"]["exporter"]
    assert ex.start_metrics_server(0) is None      # 0 = off
    reg = _feed(both["port"]["metrics"])
    want = ex.render_prometheus(reg)      # the scrape counts after it
    with ex.MetricsServer(port=0, registry=reg, host="127.0.0.1") as srv:
        base = f"http://127.0.0.1:{srv.port}"
        body = urllib.request.urlopen(base + "/metrics", timeout=10).read()
        ok = urllib.request.urlopen(base + "/healthz", timeout=10).read()
    assert ok == b"ok\n"
    assert body.decode() == want
    assert reg.counter("exporter.scrapes").value(path="/metrics") == 1
    assert srv.port is None


# -------------------------------------------------------------- heartbeat

def _heartbeat_script(mod):
    clk = FakeClock(0.0)
    stalls = []
    mon = mod.HeartBeatMonitor(3, timeout_s=2.0, interval_s=1.0,
                               on_stall=lambda w, a: stalls.append((w, a)),
                               clock=clk)
    out = [mon.check()]
    for t, ev in ((0.5, ("u", 0)), (0.6, ("u", 1)), (1.0, ("c",)),
                  (2.4, ("u", 2)), (2.7, ("c",)), (3.0, ("c",)),
                  (3.1, ("u", 0)), (3.2, ("done", 1)), (3.3, ("add",)),
                  (3.4, ("u", 3)), (6.0, ("c",)), (6.1, ("u", 1)),
                  (6.2, ("c",))):
        clk.t = t
        if ev[0] == "u":
            mon.update(ev[1])
        elif ev[0] == "done":
            mon.complete(ev[1])
        elif ev[0] == "add":
            out.append(mon.add_worker())
        else:
            out.append(mon.check())
    out += [stalls, mon.all_completed(), mon.num_workers]
    return out


def test_heartbeat_monitor_state_sequence_matches_jax():
    from paddle_tpu.parallel import heartbeat as jh
    from paddle_tpu_torch.parallel import heartbeat as ph
    want = _heartbeat_script(jh)
    got = _heartbeat_script(ph)
    assert got == want
    states = [s for step in got if isinstance(step, dict)
              for s, _ in step.values()]
    assert {"UNINITED", "RUNNING", "STALLED", "COMPLETED"} <= set(states)
    assert (ph.TIMEOUT_S, ph.INTERVAL_S) == (300.0, 10.0)
    assert ph.HeartBeatMonitor(1).timeout_s == jh.HeartBeatMonitor(
        1).timeout_s


def test_file_heartbeat_and_barrier_match_jax(tmp_path):
    from paddle_tpu.parallel import heartbeat as jh
    from paddle_tpu_torch.parallel import heartbeat as ph
    scans = {}
    for side, mod in (("jax", jh), ("port", ph)):
        d = str(tmp_path / side)
        mod.FileHeartbeat(d, 0).ping()
        mod.FileHeartbeat(d, 1).complete()
        scans[side] = {w: st for w, (st, _) in
                       mod.FileHeartbeat.scan(d, 3, 60.0).items()}
        mod.barrier_with_timeout(d, 0, 1, timeout_s=5.0)
        with pytest.raises(TimeoutError):
            mod.barrier_with_timeout(d, 0, 2, timeout_s=0.05, tag="b2",
                                     poll_s=0.01)
    assert scans["port"] == scans["jax"] == {0: "RUNNING", 1: "COMPLETED",
                                             2: "UNINITED"}


# --------------------------------------------------------------- watchdog

class Probe:
    def __init__(self):
        self.n = 1

    def _cache_size(self):
        return self.n


def _watchdog_script(mods):
    wd_mod, metrics = mods["watchdog"], mods["metrics"]
    reg = metrics.MetricsRegistry()
    log = ListLog()
    acted = []
    cfg = wd_mod.WatchdogConfig(window=16, slow_factor=3.0, stall_s=1.0,
                                goodput_min=0.5, min_samples=4,
                                warmup_steps=2, min_retired=4)
    wd = wd_mod.Watchdog(cfg, run_log=log, registry=reg,
                         clock=FakeClock(5.0), action=acted.append)
    probe = Probe()
    wd.watch_jit("serve.decode", probe)
    wd.watch_jit("not_a_jit", object())
    rs = np.random.RandomState(1)
    for step in range(40):
        wall = 0.01 + 0.001 * rs.rand()
        if step in (12, 13, 30):
            wall = 0.2                              # slow steps
        stall = 2.0 if step in (15, 16) else 0.1
        good = 0.2 if 20 <= step < 25 else 0.9
        if step in (8, 27):
            probe.n += 1                            # a retrace
        wd.tick(step, wall_s=wall, stall_s=stall, goodput=good,
                retired=step)
    fired = [wd.alert("loss_spike", 40, loss=9.0),
             wd.alert("loss_spike", 41, loss=9.5)]
    wd.resolve("loss_spike")
    fired.append(wd.alert("loss_spike", 42, loss=9.9))
    fired.append(wd.alert("ingest_error", 43, latch=False, reason="X"))
    return [wd.anomalies, acted, log.records, fired,
            reg.counter("watchdog.anomalies").snapshot(),
            reg.counter("jit.retraces").snapshot()]


def test_watchdog_fires_the_same_anomalies_as_jax(both):
    want = _watchdog_script(both["jax"])
    got = _watchdog_script(both["port"])
    assert got == want
    kinds = {a["anomaly"] for a in got[0]}
    assert kinds == {"slow_step", "ingest_stall", "retrace",
                     "goodput_collapse", "loss_spike", "ingest_error"}
    wd = both["port"]["watchdog"]
    assert wd.maybe_watchdog(None) is None and wd.maybe_watchdog(False) \
        is None
    assert isinstance(wd.maybe_watchdog(True), wd.Watchdog)
    jcfg = both["jax"]["watchdog"].WatchdogConfig().resolve()
    assert wd.WatchdogConfig().resolve() == wd.WatchdogConfig(**{
        f: getattr(jcfg, f) for f in ("window", "slow_factor", "stall_s",
                                      "goodput_min", "min_samples",
                                      "warmup_steps", "min_retired")})


# ------------------------------------------------------------------ trace

def _records(seed):
    """Two replicas' RunLog records: an anchor each (other epochs), trace
    events across both for one trace id, and other records."""
    rs = np.random.RandomState(seed)
    out = {}
    for i, wall in ((0, 1000.0), (1, 1003.5)):
        mono = 50.0 + 7 * i
        recs = [{"anchor": {"wall": wall, "mono": mono}, "pid": 10 + i}]
        for k in range(6):
            recs.append({"event": ["adopted", "admitted", "first_token",
                                   "retired"][k % 4],
                         "req": k, "trace": f"run/{k % 3}",
                         "t": mono + float(rs.rand()), "replica": i})
        recs.append({"phase": "serve", "step": 3, "wall_s": 0.1})
        out[f"r{i}"] = recs
    out["r2"] = [{"event": "submitted", "t": 0.5, "trace": None}]
    return out


def test_trace_contexts_and_merge_match_jax(both):
    jt, pt = both["jax"]["trace"], both["port"]["trace"]
    assert pt.EVENTS == jt.EVENTS
    for ctx_j, ctx_p in ((jt.TraceContext("a/1"), pt.TraceContext("a/1")),
                         (jt.TraceContext("a/1", "hop2", "hop1"),
                          pt.TraceContext("a/1", "hop2", "hop1"))):
        assert ctx_p.to_wire() == ctx_j.to_wire()
        assert ctx_p.child("x").to_wire() == ctx_j.child("x").to_wire()
        assert repr(ctx_p) == repr(ctx_j)
        back = pt.TraceContext.from_wire(ctx_j.to_wire())
        assert back.to_wire() == ctx_j.to_wire()
    assert pt.TraceContext.from_wire({}) is None
    assert pt.TraceContext.from_wire({"span_id": "x"}) is None
    merged = {side: mods["trace"].merge_fleet_trace(_records(4))
              for side, mods in both.items()}
    assert merged["port"] == merged["jax"]
    assert merged["port"]["skew"]["r2"]["anchored"] is False
    assert pt.group_by_trace(merged["port"]["events"]) \
        == jt.group_by_trace(merged["jax"]["events"])
    ctx = pt.TraceContext("t/1")
    assert pt.current() is None
    with pt.activate(ctx):
        with pt.activate(ctx.child("s")):
            assert pt.current().span_id == "s"
        assert pt.current() is ctx
    assert pt.current() is None
    assert len(pt.mint_run()) == 8
    log = ListLog()
    rec = pt.write_anchor(log, model_version="m@v0")
    assert log.records == [rec] and set(rec) == {"anchor", "pid",
                                                 "model_version"}


# ----------------------------------------------------------------- flight

@pytest.fixture
def flight_dirs(tmp_path):
    """The JAX recorder's flags and the port's settings pointed at two
    directories under tmp_path, restored after."""
    from paddle_tpu_torch.observability import flight
    saved, psaved = all_flags(), flight.configure()
    dirs = {"jax": str(tmp_path / "jax"), "port": str(tmp_path / "port")}
    set_flags({"flight_dir": dirs["jax"], "flight_ring": 64,
               "flight_profile_s": 0.0})
    flight.configure(ring=64, directory=dirs["port"], profile_s=0.0)
    yield dirs
    set_flags(saved)
    flight.configure(**psaved)


def test_dump_bundle_writes_the_same_bundle_as_jax(both, flight_dirs,
                                                   tmp_path):
    out = {}
    for side, mods in both.items():
        fl, runlog = mods["flight"], mods["runlog"]
        rec = fl.recorder()
        assert rec is not None and rec.size == 64
        rec.note_event("anomaly", anomaly="goodput_collapse", step=3)
        rec.note({"event": "retired", "req": 1, "t": 1.0})
        rec.note_metric_delta("serve.tokens", 4, replica="0")
        log_path = str(tmp_path / f"{side}.jsonl")
        with runlog.RunLog(log_path) as rl:
            for i in range(5):
                rl.write({"phase": "serve", "step": i})
        path = fl.dump_bundle("goodput_collapse", run_logs=[log_path, ""],
                              config={"fleet": {"states": ["live"]},
                                      "obj": object()},
                              extra={"anomaly": {"anomaly": "x"}}, tail=3)
        assert path and fl.last_bundle() == path
        man = fl.read_manifest(path)
        with open(os.path.join(path, "runlog_tail.jsonl")) as f:
            tail = [json.loads(ln) for ln in f]
        with open(os.path.join(path, "ring.jsonl")) as f:
            ring = [json.loads(ln) for ln in f]
        out[side] = dict(
            files=sorted(os.listdir(path)), keys=sorted(man),
            sections=man["sections"], reason=man["reason"],
            tail=[{k: v for k, v in r.items() if k != "_runlog"}
                  for r in tail],
            ring=[(r.get("event"), r.get("metric")) for r in ring[-3:]],
            listed=[os.path.basename(p) == os.path.basename(path)
                    for p in fl.list_bundles()][-1:])
    assert out["port"] == out["jax"]
    assert out["port"]["files"] == ["MANIFEST.json", "config.json",
                                    "metrics.json", "ring.jsonl",
                                    "runlog_tail.jsonl"]


def test_flight_dump_fault_is_swallowed_and_recording_can_be_off(
        both, flight_dirs):
    from paddle_tpu_torch.observability import flight, metrics
    from paddle_tpu_torch.testing import chaos
    err0 = metrics.counter("flight.dumps").value(status="error")
    plan = chaos.FaultPlan().fail("fault_point", path=r"^flight\.dump$")
    with chaos.active(plan):
        assert flight.dump_bundle("x") is None
    assert metrics.counter("flight.dumps").value(status="error") \
        == err0 + 1
    flight.configure(ring=0)
    assert flight.recorder() is None
    assert flight.list_bundles(flight_dirs["port"] + "/none") == []


# ------------------------------------------------ the plane in the engines

def _engine_pair():
    from tests.test_torch_fleet import pair
    return pair(0)


def test_engine_watchdog_sheds_like_jax(flight_dirs):
    """An SLO nobody meets collapses goodput: both engines' watchdogs
    fire the same anomalies at the same steps and shed the same queued
    requests; each standalone engine writes its own flight bundle."""
    from paddle_tpu.observability.watchdog import WatchdogConfig as JW
    from paddle_tpu.serving import ServeConfig as JServe
    from paddle_tpu.serving import ServingEngine as JEngine
    from paddle_tpu_torch.observability import flight
    from paddle_tpu_torch.observability.watchdog import WatchdogConfig
    from paddle_tpu_torch.serving import ServeConfig, ServingEngine
    from tests.test_torch_fleet import SERVE, Clock, prompts_of
    jm, v, pm = _engine_pair()
    kw = dict(SERVE, slo_ttft_s=1e-9)
    wd = dict(min_retired=2, goodput_min=0.5, min_samples=1000)
    je = JEngine(jm, v, JServe(metrics_port=0, watchdog=JW(**wd), **kw),
                 clock=Clock())
    pe = ServingEngine(pm, ServeConfig(watchdog=WatchdogConfig(**wd), **kw),
                       clock=Clock())
    out = []
    for eng in (je, pe):
        for p in prompts_of(8, seed=41):
            eng.submit(p, max_new=3)
        eng.drain()
        out.append(([(a["anomaly"], a["step"])
                     for a in eng._watchdog.anomalies],
                    [(r.status, r.retire_reason, r.tokens)
                     for r in eng.requests.values()]))
    assert out[1] == out[0]
    assert out[1][0] == [("goodput_collapse", out[1][0][0][1])]
    assert any(s == "shed" for s, _, _ in out[1][1])
    bundles = flight.list_bundles()
    assert bundles and flight.read_manifest(bundles[-1])["reason"] \
        == "goodput_collapse"
    cfg = flight.read_manifest(bundles[-1])
    assert cfg["anomaly"]["anomaly"] == "goodput_collapse"


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_fleet_owns_one_exporter_and_one_flight_bundle(flight_dirs,
                                                       tmp_path):
    """The router's exporter serves the fleet gauges and every replica's
    serve counters (the replicas start none); a replica's anomaly goes up
    its sink and the router writes one bundle with every replica's
    RunLog tail; each replica keeps its own RunLog."""
    from paddle_tpu_torch.observability import flight
    from paddle_tpu_torch.observability.runlog import read_records
    from paddle_tpu_torch.observability.watchdog import WatchdogConfig
    from paddle_tpu_torch.serving import (FleetConfig, FleetRouter,
                                          ServeConfig)
    from tests.test_torch_fleet import SERVE, prompts_of
    _, _, pm = _engine_pair()
    port = _free_port()
    log = str(tmp_path / "serve.jsonl")
    r = FleetRouter(pm, FleetConfig(num_replicas=2, metrics_port=port),
                    serve_config=ServeConfig(
                        run_log=log, slo_ttft_s=1e-9, metrics_port=port,
                        watchdog=WatchdogConfig(min_retired=2,
                                                min_samples=1000),
                        **SERVE), sleep=lambda s: None)
    assert all(h.engine._metrics_server is None for h in r._replicas)
    for p in prompts_of(10, seed=42):
        r.submit(p, max_new=3)
    r.drain()
    body = urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                  timeout=10).read().decode()
    r.close()
    assert 'fleet_replicas{state="draining"} 2' in body
    assert "# HELP fleet_handoffs" in body and "serve_tokens" in body
    bundles = flight.list_bundles()
    assert len(bundles) == 1
    man = flight.read_manifest(bundles[0])
    assert man["reason"] == "goodput_collapse" and "source_replica" in man
    with open(os.path.join(bundles[0], "runlog_tail.jsonl")) as f:
        logs = {json.loads(ln)["_runlog"] for ln in f}
    assert logs == {f"{log}.r0", f"{log}.r1"}
    for i in range(2):
        recs = read_records(f"{log}.r{i}")
        assert "anchor" in recs[0]
        assert {e.get("replica") for e in recs if "event" in e} == {i}
