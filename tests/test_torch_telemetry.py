"""The port's step telemetry, spans and performance arithmetic against the
JAX package's, on the CPU.

The telemetry runs are the JAX tests' own: a [4, 1] linear regression
under SGD(0.1) on seeded [8, 4] batches, through both Trainers with the
same TelemetryConfig; records must come at the same steps with the same
keys, losses within 1e-5 (f32). The chaos cases inject the same faults
into both packages' filesystems and compare the counters' movements.
"""

import os
import socket
import subprocess
import sys
import threading
import urllib.error
import urllib.request
import uuid

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

torch.set_num_threads(1)


def _batches(n=10, b=8):
    rng = np.random.RandomState(0)
    return [(rng.rand(b, 4).astype(np.float32),
             rng.rand(b, 1).astype(np.float32)) for _ in range(n)]


def _jax_step():
    import paddle_tpu as pt
    opt = pt.optimizer.SGD(0.1)
    params = {"w": jnp.zeros((4, 1))}
    state = {"params": params, "opt": opt.init(params)}

    @jax.jit
    def step(st, x, y):
        def loss_fn(p):
            return jnp.mean(jnp.square(x @ p["w"] - y))
        loss, grads = jax.value_and_grad(loss_fn)(st["params"])
        p, o = opt.apply_gradients(st["params"], grads, st["opt"])
        return loss, {"params": p, "opt": o}

    return step, state


class _Lin(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.w = torch.nn.Parameter(torch.zeros(4, 1))


def _lin_loss(m, x, y):
    return torch.mean(torch.square(x @ m.w - y))


def _port_trainer(cfg, loss_fn=_lin_loss):
    from paddle_tpu_torch.optimizer import SGD
    from paddle_tpu_torch.static import Trainer
    model = _Lin()
    return Trainer(model, SGD(model.parameters(), 0.1), loss_fn, cfg,
                   device="cpu")


def _feed(n):
    data = _batches(n)
    return lambda: iter(data)


def _records(path):
    from paddle_tpu_torch.observability.runlog import read_records
    return read_records(path)


def _steps(recs):
    return [r for r in recs if "step" in r and not r.get("final")]


# ------------------------------------------------------------- telemetry

def test_runlog_records_match_the_jax_trainer(tmp_path):
    from paddle_tpu.observability import TelemetryConfig as JT
    from paddle_tpu.observability.runlog import read_records as jread
    from paddle_tpu.static import Trainer, TrainerConfig
    from paddle_tpu_torch.observability import TelemetryConfig
    from paddle_tpu_torch.static import TrainerConfig as PC
    step, state = _jax_step()
    jlog, plog = str(tmp_path / "j.jsonl"), str(tmp_path / "p.jsonl")
    Trainer(step, TrainerConfig(num_ingest_threads=1, telemetry=JT(
        enabled=True, run_log=jlog, every_n_steps=2))).train(state, _feed(7))
    tr = _port_trainer(PC(num_ingest_threads=1, telemetry=TelemetryConfig(
        enabled=True, run_log=plog, every_n_steps=2)))
    assert tr.train(_feed(7))["steps"] == 7
    jrec, prec = jread(jlog), _records(plog)
    js, ps = _steps(jrec), _steps(prec)
    assert [r["step"] for r in ps] == [r["step"] for r in js] == [2, 4, 6]
    for a, b in zip(js, ps):
        assert sorted(a) == sorted(b)
        np.testing.assert_allclose(b["loss"], a["loss"], rtol=1e-5,
                                   atol=1e-6)
        assert isinstance(b["wall_s"], float) and b["wall_s"] > 0
        assert b["tokens_per_s"] > 0
        assert b["mfu"] is None and b["memory"] is None   # no card
    jf = [r for r in jrec if r.get("final")]
    pf = [r for r in prec if r.get("final")]
    assert len(pf) == len(jf) == 1
    assert sorted(pf[0]) == sorted(jf[0])
    assert pf[0]["steps"] == 7 and pf[0]["step_time"]["count"] == 7
    assert "trainer.ingest_stall_s" in pf[0]["counters"]
    assert {r["name"] for r in pf[0]["spans"]} >= {"ingest", "stage",
                                                   "step"}
    anchors = [r for r in prec if "anchor" in r]
    assert len(anchors) == 1 and anchors[0]["role"] == "trainer"
    assert len(tr.telemetry.records) == len(prec) - len(anchors)


def test_no_read_of_the_loss_just_dispatched(tmp_path, monkeypatch):
    """No item/float/cpu/tolist/numpy call on the loss of the step just
    dispatched while the loop runs, and every mid-run flush is of a step
    strictly older than the current one."""
    from paddle_tpu_torch.observability import TelemetryConfig
    from paddle_tpu_torch.observability import telemetry as T
    from paddle_tpu_torch.static import TrainerConfig
    current = {"loss": None}
    bad = []
    for meth in ("item", "__float__", "cpu", "tolist", "numpy"):
        orig = getattr(torch.Tensor, meth)

        def spy(self, *a, _orig=orig, _m=meth, **kw):
            if current["loss"] is not None and self is current["loss"]:
                bad.append(_m)
            return _orig(self, *a, **kw)
        monkeypatch.setattr(torch.Tensor, meth, spy)
    flushes = []
    orig_flush, orig_on, orig_finish = (T.StepTelemetry._flush_pending,
                                        T.StepTelemetry.on_step,
                                        T.StepTelemetry.finish)

    def on_step(self, step, batch, loss, *a, **kw):
        current["loss"] = loss
        return orig_on(self, step, batch, loss, *a, **kw)

    def flush(self, at_step=None):
        if self._pending is not None:
            flushes.append((self._pending[0], at_step))
        return orig_flush(self, at_step=at_step)

    def finish(self, *a, **kw):
        current["loss"] = None
        return orig_finish(self, *a, **kw)

    monkeypatch.setattr(T.StepTelemetry, "on_step", on_step)
    monkeypatch.setattr(T.StepTelemetry, "_flush_pending", flush)
    monkeypatch.setattr(T.StepTelemetry, "finish", finish)
    run_log = str(tmp_path / "run.jsonl")
    _port_trainer(TrainerConfig(num_ingest_threads=1, telemetry=(
        TelemetryConfig(enabled=True, run_log=run_log,
                        every_n_steps=1)))).train(_feed(6))
    assert bad == []
    mid = [(p, a) for p, a in flushes if a is not None]
    assert mid and all(p < a for p, a in mid)
    assert flushes[-1][1] is None
    assert [r["step"] for r in _steps(_records(run_log))] == [1, 2, 3, 4, 5,
                                                              6]


def test_flag_driven_enablement(tmp_path):
    from paddle_tpu_torch.observability import telemetry as T
    from paddle_tpu_torch.static import TrainerConfig
    run_log = str(tmp_path / "flag_run.jsonl")
    old = T.configure()
    T.configure(telemetry=True, telemetry_run_log=run_log,
                telemetry_every_n=1)
    try:
        _port_trainer(TrainerConfig(num_ingest_threads=1)).train(_feed(3))
    finally:
        T.configure(**old)
    assert [r["step"] for r in _steps(_records(run_log))] == [1, 2, 3]
    # the environment alone, read at import, as the reference's flags are
    env = dict(os.environ, PT_FLAGS_telemetry="1",
               PT_FLAGS_telemetry_every_n="3",
               PT_FLAGS_telemetry_run_log=run_log)
    out = subprocess.run(
        [sys.executable, "-c",
         "from paddle_tpu_torch.observability import telemetry as T; "
         "c = T.TelemetryConfig().resolve(); "
         "print(c.enabled, c.every_n_steps, c.run_log)"],
        env=env, capture_output=True, text=True, timeout=120)
    assert out.stdout.split() == ["True", "3", run_log], out.stderr


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_metrics_port_starts_and_stops_exporter():
    from paddle_tpu_torch.observability.telemetry import (StepTelemetry,
                                                          TelemetryConfig)
    port = _free_port()
    tele = StepTelemetry(TelemetryConfig(enabled=True, metrics_port=port))
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz",
                                    timeout=10) as r:
            assert r.read() == b"ok\n"
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                    timeout=10) as r:
            assert b"trainer_step_s" in r.read()
    finally:
        tele.finish()
    with pytest.raises((urllib.error.URLError, ConnectionError)):
        urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz",
                               timeout=2)


def test_disabled_telemetry_is_free():
    from paddle_tpu_torch.static import TrainerConfig
    tr = _port_trainer(TrainerConfig(num_ingest_threads=1))
    tr.train(_feed(2))
    assert tr.telemetry is None and tr.watchdog is None


def test_grad_norm_fn_and_tokens_fn(tmp_path):
    from paddle_tpu_torch.observability import TelemetryConfig
    from paddle_tpu_torch.static import TrainerConfig
    run_log = str(tmp_path / "run.jsonl")
    tcfg = TelemetryConfig(enabled=True, run_log=run_log, every_n_steps=1,
                           tokens_fn=lambda batch: 123,
                           grad_norm_fn=lambda m: torch.linalg.norm(
                               m.w.detach()))
    _port_trainer(TrainerConfig(num_ingest_threads=1,
                                telemetry=tcfg)).train(_feed(3))
    recs = _steps(_records(run_log))
    assert len(recs) == 3
    for r in recs:
        assert r["tokens_per_s"] == pytest.approx(123 / r["wall_s"])
        assert isinstance(r["grad_norm"], float)


def test_preempted_counter_and_final_record(tmp_path):
    import signal
    from paddle_tpu_torch.observability import TelemetryConfig
    from paddle_tpu_torch.observability import metrics as M
    from paddle_tpu_torch.static import Preempted, TrainerConfig
    c0 = M.counter("trainer.preempted").total()
    run_log = str(tmp_path / "run.jsonl")
    fired = {"done": False}

    def loss_fn(m, x, y):
        if not fired["done"]:
            fired["done"] = True
            os.kill(os.getpid(), signal.SIGTERM)
        return _lin_loss(m, x, y)

    tr = _port_trainer(TrainerConfig(
        num_ingest_threads=1, handle_preemption=True,
        checkpoint_dir=str(tmp_path / "ck"), checkpoint_every=100,
        telemetry=TelemetryConfig(enabled=True, run_log=run_log,
                                  every_n_steps=1)), loss_fn)
    with pytest.raises(Preempted):
        tr.train(_feed(6))
    assert M.counter("trainer.preempted").total() == c0 + 1
    finals = [r for r in _records(run_log) if r.get("final")]
    assert finals and finals[-1]["preempted"] is True


# ---------------------------------------------------- counters under chaos

def _retry_fast():
    from paddle_tpu.core import flags as JF
    from paddle_tpu_torch.core import retry as R
    jold = {k: JF.get_flag(k) for k in ("retry_max_attempts",
                                        "retry_backoff_base_s")}
    JF.set_flags({"retry_max_attempts": 2, "retry_backoff_base_s": 0.001})
    pold = R.configure()
    R.configure(max_attempts=2, backoff_s=0.001)

    def restore():
        JF.set_flags(jold)
        R.configure(**pold)
    return restore


def test_retry_attempts_increment_under_injected_write_faults(tmp_path):
    from paddle_tpu.io import fs as jfs
    from paddle_tpu.observability import metrics as JM
    from paddle_tpu.testing import chaos as jchaos
    from paddle_tpu_torch.io import fs as pfs
    from paddle_tpu_torch.observability import metrics as PM
    from paddle_tpu_torch.testing import chaos as pchaos
    src = tmp_path / "src"
    src.mkdir()
    (src / "a.bin").write_bytes(b"x" * 64)
    out = []
    for fs, ch, M in ((jfs, jchaos, JM), (pfs, pchaos, PM)):
        plan = ch.FaultPlan().fail("write", times=2)
        s = f"obs{uuid.uuid4().hex[:8]}"
        fs.register_filesystem(s, ch.ChaosFS(fs.MemFS(), plan))
        att = M.counter("retry.attempts")
        before = att.value(op="copy_one")
        fs.put_tree(str(src), f"{s}://ck/1")     # retries through
        out.append((plan.fired("write"), att.value(op="copy_one") - before))
    assert out[0] == out[1] == (2, 2)


def test_torn_commit_and_mirror_degraded_counters():
    from paddle_tpu.io import fs as jfs
    from paddle_tpu.io.checkpoint import CheckpointManager as JMgr
    from paddle_tpu.observability import metrics as JM
    from paddle_tpu.testing import chaos as jchaos
    from paddle_tpu_torch.io import fs as pfs
    from paddle_tpu_torch.io.checkpoint import CheckpointManager as PMgr
    from paddle_tpu_torch.observability import metrics as PM
    from paddle_tpu_torch.testing import chaos as pchaos
    restore = _retry_fast()
    out = []
    try:
        for fs, ch, M, Mgr, state in (
                (jfs, jchaos, JM, JMgr, {"w": np.ones((2,), np.float32)}),
                (pfs, pchaos, PM, PMgr, {"w": torch.ones(2)})):
            plan = ch.FaultPlan().fail("write", path=r"COMMIT",
                                             times=20)
            s = f"obs{uuid.uuid4().hex[:8]}"
            fs.register_filesystem(s, ch.ChaosFS(fs.MemFS(), plan))
            remote = f"{s}://ck"
            deg, torn = (M.counter("checkpoint.mirror_degraded"),
                         M.counter("checkpoint.torn_skips"))
            d0, t0 = deg.total(), torn.total()
            mgr = Mgr(remote, save_interval_steps=1)
            try:
                assert mgr.save(1, state)
                mgr.wait()
                pending = list(mgr._mirror_pending)
                restored, at = Mgr(remote).restore(state)
            finally:
                mgr.close()
            out.append((deg.total() - d0 >= 1, pending, restored, at,
                        torn.total() > t0))
    finally:
        restore()
    assert out[0] == out[1] == (True, [1], None, None, True)


# ------------------------------------------------------------------ spans

def test_spans_nest_per_thread_and_match_jax():
    from paddle_tpu.observability import spans as J
    from paddle_tpu_torch.observability import spans as P
    from paddle_tpu_torch.observability.catalog import lookup
    rows = []
    for mod in (J, P):
        mod.reset_spans()

        def work(tag, mod=mod):
            with mod.span("step"):
                with mod.span(tag):
                    pass
                with mod.span(tag):
                    pass
        threads = [threading.Thread(target=work, args=(t,))
                   for t in ("stage", "ingest")]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        rows.append(sorted((r["name"], r["calls"])
                           for r in mod.span_summary()))
        assert "step/stage" in mod.span_report()
    assert rows[0] == rows[1] == [("step", 2), ("step/ingest", 2),
                                  ("step/stage", 2)]
    assert lookup("span.step/stage") is not None
    P.reset_spans()


def test_span_survives_an_exception():
    from paddle_tpu_torch.observability import metrics as M
    from paddle_tpu_torch.observability import spans as P
    P.reset_spans()
    with pytest.raises(ValueError):
        with P.span("outer"):
            with P.span("boom"):
                raise ValueError("x")
    with P.span("after"):
        pass
    names = {r["name"]: r["calls"] for r in P.span_summary()}
    assert names == {"outer": 1, "outer/boom": 1, "after": 1}
    assert M.histogram("span.outer/boom").count() >= 1

    @P.annotate_span("deco")
    def f():
        return 3
    assert f() == 3 and "deco" in {r["name"] for r in P.span_summary()}
    P.reset_spans()


# ------------------------------------------------------------------- perf

def test_mfu_arithmetic_matches_jax(monkeypatch):
    from paddle_tpu.observability import perf as J
    from paddle_tpu_torch.observability import perf as P
    assert P.peak_flops() is None and P.mfu(1e12, 0.5) is None  # no card
    assert P.device_memory_stats() is None
    monkeypatch.setenv("PT_PEAK_FLOPS", "4e12")
    for flops, s in ((1e12, 0.5), (3e12, 1.5), (0.0, 1.0), (1e12, 0.0)):
        assert P.mfu(flops, s) == J.mfu(flops, s)
    assert P.mfu(1e12, 0.5) == 0.5 and P.peak_flops() == 4e12


def test_cost_flops_counts_the_plain_step_and_moves_nothing():
    """The meta-device count equals FlopCounterMode over the real CPU
    step (the kernels' plain route), and counting moves no buffer, no
    generator and no gradient."""
    from torch.utils.flop_counter import FlopCounterMode
    from paddle_tpu_torch.models.bert import BertConfig, BertForPretraining
    from paddle_tpu_torch.nn import BatchNorm
    from paddle_tpu_torch.observability.perf import cost_flops
    cfg = BertConfig(vocab_size=64, hidden_size=32, num_layers=2,
                     num_heads=2, intermediate_size=64, max_position=32,
                     dropout=0.1)
    model = BertForPretraining(cfg, device="cpu", seed=0)
    model.bn = BatchNorm(32)
    rs = np.random.RandomState(0)
    ids = torch.from_numpy(rs.randint(0, 64, (2, 16)))

    def loss_fn(m, ids):
        mlm, nsp = m(ids)
        h = m.bn(mlm.float()[:, 0, :32].contiguous())
        return mlm.float().square().mean() + nsp.float().sum() + h.sum()

    gen0 = model.dropout_gen.get_state()
    bufs = {k: b.clone() for k, b in model.named_buffers()}
    counted = cost_flops(loss_fn, model, ids)
    assert torch.equal(model.dropout_gen.get_state(), gen0)
    for k, b in model.named_buffers():
        assert torch.equal(b, bufs[k]), k
    assert all(p.grad is None for p in model.parameters())
    with FlopCounterMode(display=False) as fc:
        loss_fn(model, ids).backward()
    assert counted == fc.get_total_flops() > 0
    assert cost_flops(lambda m, x: m.missing(x), model, ids) == 0.0


def test_profiler_trace_op_table_and_event_recorder(tmp_path):
    """``profiler()`` writes a Chrome trace whose op table holds the
    region's operators and its named scopes; ``EventRecorder`` gives the
    reference's table for the same timings as the JAX one."""
    from paddle_tpu.profiler import EventRecorder as JRec
    from paddle_tpu_torch import profiler as P
    a = torch.randn(64, 64)

    @P.annotate_fn("ann_fn")
    def work():
        return a @ a

    with P.profiler(str(tmp_path)) as out:
        with P.record_event("region"):
            for _ in range(3):
                work()
    assert out == str(tmp_path)
    ops = {r["name"]: r for r in P.trace_op_table(out, device_filter=None,
                                                  top=None)}
    assert ops["aten::mm"]["count"] == 3 and ops["region"]["count"] == 1
    assert ops["ann_fn"]["count"] == 3
    assert P.print_op_table(out, device_filter="cpu_op", top=3)
    with pytest.raises(FileNotFoundError):
        P.trace_op_table(str(tmp_path / "none"))
    rows = []
    for rec in (JRec(), P.EventRecorder()):
        for name, sec in (("a", 0.002), ("a", 0.004), ("b", 0.001)):
            rec.add(name, sec)
        rows.append((rec.summary(), rec.report()))
    assert rows[0] == rows[1]
