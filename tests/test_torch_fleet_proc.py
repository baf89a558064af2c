"""The fleet across processes and the trace switch, the port's against
the JAX package's.

* ``_pack``/``_unpack`` (the JSON wire over ``host_allgather``) give the
  JAX functions' bytes and read each other's payloads.
* A :class:`SubprocessReplica` fleet on the CPU: the child worker imports
  only torch and ``paddle_tpu_torch`` (jax, jaxlib and paddle_tpu cannot
  be imported there) and loads the JAX tiny GPT's weights from an
  ``.npz`` this test writes; an :class:`InProcessReplica` is the spare.
  The child is killed -9 mid-stream, respawns at generation 1, every
  request finishes token-exact against the JAX ``ServingEngine`` serving
  the same prompts alone, and the children's and the spare's RunLogs
  merge into one timeline where a re-routed request keeps its trace id
  across processes.
* ``trace_fleet`` off with the flight ring at 0: no trace id is minted,
  and the router's statuses and tokens are the JAX router's under
  ``set_flags({"trace_fleet": False, "flight_ring": 0})``.
"""

import json
import os
import sys

import numpy as np
import pytest

from paddle_tpu.core.flags import all_flags, set_flags
from tests.test_torch_fleet import (SERVE, compare, fast_retry,  # noqa
                                    kill, pair, prompts_of)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_WORKER = r"""
import importlib.abc, json, os, sys
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "paddle_tpu"):
            raise ImportError("blocked: " + name)
        return None
sys.meta_path.insert(0, Block())
sys.path.insert(0, {root!r})
import numpy as np, torch
torch.set_num_threads(1)
from paddle_tpu_torch import bridge
from paddle_tpu_torch.models.gpt import GPTConfig, GPTDecoder
from paddle_tpu_torch.serving import (ServeConfig, ServingEngine,
                                      replica_worker_loop)
cfg = GPTConfig.tiny()
cfg.dropout = 0.0
model = GPTDecoder(cfg, device="cpu", seed=99)
with np.load({weights!r}) as z:
    bridge.load_params(model, dict(z))
rep = os.environ["PT_FLEET_REPLICA"]
gen = os.environ["PT_FLEET_GENERATION"]
log = os.path.join({out!r}, "serve.r%s.g%s.jsonl" % (rep, gen))
engine = ServingEngine(model, ServeConfig(run_log=log, **{serve!r}))
replica_worker_loop(engine)
engine.close()
with open(os.path.join({out!r}, "done.r%s.g%s.json" % (rep, gen)),
          "w") as f:
    json.dump(dict(steps=engine.decode_steps,
                   staged=engine.staged_prefills,
                   prefills=engine.prefill_calls,
                   modules=sorted(m for m in sys.modules if m.split(".")[0]
                                  in ("jax", "jaxlib", "paddle_tpu"))), f)
"""


@pytest.mark.parametrize("obj", [
    {},
    {"op": "round", "submit": []},
    {"op": "stop", "submit": []},
    {"submitted": [{"key": 0, "rid": 3}], "queued": 1, "active": 2,
     "finished": [{"rid": 3, "status": "done", "reason": "length",
                   "tokens": [5, 7, 11], "slo_ok": True,
                   "first_token_age_s": 0.125}],
     "inflight": [{"rid": 4, "status": "running", "tokens": [],
                   "first_token_age_s": None}]},
    {"op": "round", "submit": [{
        "key": 9, "prompt": [1, 2, 3], "tokens": [4], "max_new": 6,
        "eos_id": None, "priority": -1, "origin": "failover",
        "temperature": 0.8, "top_k": 50, "top_p": 0.95, "seed": 12345,
        "deadline_in_s": 1.5, "submit_age_s": 0.25,
        "first_token_age_s": None,
        "trace": {"trace_id": "ab12cd34/9", "span_id": "hop1",
                  "parent_span_id": "hop0"}}]},
])
def test_pack_and_unpack_match_jax(obj):
    from paddle_tpu.serving.fleet import _pack as jpack
    from paddle_tpu.serving.fleet import _unpack as junpack
    from paddle_tpu_torch.serving.fleet import _pack, _unpack
    got, want = _pack(obj), jpack(obj)
    assert got.dtype == want.dtype == np.uint8
    assert got.tobytes() == want.tobytes()
    assert _unpack(want) == junpack(got) == obj


def _jax_alone(prompts, max_new):
    """Each prompt's tokens from the JAX ServingEngine serving the
    prompts alone, in order."""
    from paddle_tpu.serving import ServeConfig, ServingEngine
    jm, v, _ = pair(0)
    eng = ServingEngine(jm, v, ServeConfig(metrics_port=0, **SERVE))
    rids = [eng.submit(p, max_new=max_new) for p in prompts]
    eng.drain()
    return [list(eng.requests[r].tokens) for r in rids]


def test_subprocess_replica_survives_a_kill_token_exact(tmp_path):
    """A kill -9 mid-stream: the router catches the dead child before
    its next exchange, re-routes its requests from the mirror, respawns
    it at generation 1 (stale exchange files isolated), and every
    request finishes token-exact against the JAX engine alone. The
    respawned child serves and stops on ``close()`` with no reference
    module loaded; one merged timeline spans the processes."""
    from paddle_tpu_torch.observability import trace
    from paddle_tpu_torch.observability.runlog import read_records
    from paddle_tpu_torch.serving import (FleetConfig, FleetRouter,
                                          InProcessReplica, ServeConfig,
                                          ServingEngine, SubprocessReplica)
    jm, v, pm = pair(0)
    weights = str(tmp_path / "tiny.npz")
    np.savez(weights, **_flat(v["params"]))
    out = tmp_path / "out"
    out.mkdir()
    script = tmp_path / "worker.py"
    script.write_text(_WORKER.format(root=ROOT, weights=weights,
                                     out=str(out), serve=SERVE))
    spare_log = str(out / "spare.jsonl")
    sub = SubprocessReplica(
        [sys.executable, str(script)], str(tmp_path / "xdir"), replica=0,
        env={"CUDA_VISIBLE_DEVICES": ""}, timeout_s=120.0)
    spare = InProcessReplica(lambda: ServingEngine(
        pm, ServeConfig(run_log=spare_log, **SERVE)))
    router = FleetRouter(
        config=FleetConfig(num_replicas=2, heartbeat_s=200.0),
        serve_config=ServeConfig(**SERVE), replicas=[sub, spare],
        sleep=lambda s: None)
    prompts = prompts_of(5, seed=11, lo=3, hi=40)
    try:
        fids = [router.submit(p, max_new=6) for p in prompts]
        on_sub = [f for f in fids if router.requests[f].replica == 0]
        assert on_sub, "no request landed on the subprocess replica"
        router.step()                  # one full wire round (start-up)
        assert sub.telemetry()["generation"] == 0
        sub.kill()                     # kill -9 the worker process
        assert not sub.alive()
        router.drain()
        assert router.failovers >= 1
        assert sub.generation == 1 and sub.alive()
        crossed = [f for f in on_sub if router.requests[f].reroutes]
        assert crossed
    finally:
        router.close()
    want = _jax_alone(prompts, 6)
    for fid, tokens in zip(fids, want):
        rec = router.requests[fid]
        assert rec.status == "done", (fid, rec.status)
        assert list(rec.tokens) == tokens, fid
    with open(out / "done.r0.g1.json") as f:
        report = json.load(f)
    assert report["modules"] == []
    assert report["staged"] == report["prefills"]
    assert not (out / "done.r0.g0.json").exists()     # killed, no stop

    logs = {name[:-len(".jsonl")]: read_records(str(out / name))
            for name in os.listdir(out) if name.endswith(".jsonl")}
    assert {"serve.r0.g0", "spare"} <= set(logs)
    merged = trace.merge_fleet_trace(logs)
    assert all(s["anchored"] for s in merged["skew"].values())
    groups = trace.group_by_trace(merged["events"])
    for fid in crossed:
        tid = router.requests[fid].trace_id
        evs = groups.get(tid) or []
        sources = {e["source"] for e in evs}
        assert "serve.r0.g0" in sources and len(sources) >= 2, (
            tid, [(e["source"], e["event"]) for e in evs])
        assert evs[-1]["event"] == "retired"
        assert [e["wall_t"] for e in evs] == sorted(e["wall_t"]
                                                    for e in evs)


def _flat(params, prefix=""):
    """The JAX param tree as ``{"a.b.c": array}`` (the bridge's names)."""
    out = {}
    for key, val in params.items():
        name = f"{prefix}{key}"
        if isinstance(val, dict):
            out.update(_flat(val, name + "."))
        else:
            out[name] = np.asarray(val)
    return out


@pytest.fixture
def untraced(fast_retry):
    """Both packages with the fleet trace and the flight ring off."""
    from paddle_tpu.observability import flight as jflight
    from paddle_tpu_torch.observability import flight
    from paddle_tpu_torch.serving import fleet
    saved = all_flags()
    was_trace = fleet.configure()["trace_fleet"]
    was_ring = flight.configure()["ring"]
    set_flags({"trace_fleet": False, "flight_ring": 0})
    fleet.configure(trace_fleet=False)
    flight.configure(ring=0)
    assert flight.recorder() is None and jflight.recorder() is None
    yield
    fleet.configure(trace_fleet=was_trace)
    flight.configure(ring=was_ring)
    set_flags(saved)


def test_trace_switch_off_mints_no_ids_and_matches_jax(untraced):
    """With ``trace_fleet`` off no request gets a fleet trace id and no
    dispatch carries a context (each engine falls back to its own run's
    ids), through a kill and its failover; statuses, reasons, tokens,
    replicas and the fleet counters equal the JAX router's."""
    seen = {}

    def scenario(side):
        fids = kill(side)
        r = side.router
        seen[side.name] = dict(
            fleet=[r.requests[f].trace_id for f in fids],
            engine=[req.trace_id for h in r._replicas
                    for req in h.engine.requests.values()],
            spans=[req.span_id for h in r._replicas
                   for req in h.engine.requests.values()])
        return fids

    compare(scenario, dict(num_replicas=2))
    for name in ("jax", "port"):
        assert set(seen[name]["fleet"]) == {None}, name
        assert seen[name]["engine"] and set(seen[name]["spans"]) == {None}
        assert None not in seen[name]["engine"]   # engine-run scoped ids


def test_trace_switch_reads_the_environment():
    """``PT_FLAGS_trace_fleet=0`` turns the switch off at import, as the
    reference's flag does."""
    import subprocess
    code = ("import sys; sys.path.insert(0, %r); "
            "from paddle_tpu_torch.serving import fleet; "
            "print(fleet.configure()['trace_fleet'])" % ROOT)
    from paddle_tpu_torch.serving import fleet
    assert fleet.configure()["trace_fleet"] is True      # the default
    got = subprocess.run([sys.executable, "-c", code],
                         env=dict(os.environ, PT_FLAGS_trace_fleet="0"),
                         capture_output=True, text=True, timeout=120)
    assert got.stdout.strip() == "False", got.stderr


@pytest.mark.parametrize("error", [RuntimeError, TimeoutError, KeyError])
def test_close_kills_the_child_whatever_the_stop_raises(tmp_path, error):
    """``close`` stops the child even when sending ``stop`` fails with an
    error of any kind, as the reference's ``except Exception`` does, so a
    router's close of its handles in turn leaves no child running."""
    from paddle_tpu_torch.serving import SubprocessReplica
    handle = SubprocessReplica(
        [sys.executable, "-c", "import time; time.sleep(120)"],
        str(tmp_path / "x"), timeout_s=5.0)
    proc = handle._proc

    def broken(*args, **kwargs):
        raise error("the exchange broke")

    handle._exchange = broken
    handle.close()
    assert proc.poll() is not None
    assert not handle.alive()
