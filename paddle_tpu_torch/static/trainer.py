"""Trainer runtime (ref: ``paddle_tpu/static/trainer.py``).

Host ingestion threads fill a bounded channel; one loop dequeues, stages
the batch on the device (pinned host memory, copied on the default
stream, so the step's kernels see it after the copy lands) and, with
``prefetch``, collates the next batch while the step runs. The step is
``optimizer.minimize(model, loss_fn, *batch)``, or its gated form under
the guardian (which also holds the model's floating buffers, batch
norm's running statistics, so a refused step leaves them as they were).
The Trainer saves ``{"params", "opt", "buffers"}`` keyed by name every
``checkpoint_every`` steps, with the data cursor, the states of the
generators the step draws from (``core/random.py``) and the guardian's
state in the step's meta, and resumes from the newest healthy step
(``dataset.seek(step)`` replays the stream); a checkpoint without
``"buffers"`` (written before they were saved) restores with the
model's current buffers and a warning. Saves run in the background
(``io/checkpoint.py``): a rollback and a preemption wait for them, and
the run's end closes the manager. Under the guardian a non-finite step
is refused in place, and the ladder re-reads or rolls back to the last
good checkpoint and replays the stream to its cursor.

The run's observability, each opt-in: ``telemetry`` (a
``TelemetryConfig``, or the ``telemetry`` setting) writes step records to
a RunLog (the FLOPs of a step counted once, on the first); ``watchdog``
ticks with each step's wall and ingest-wait time, alerts on a dead
reader, and dumps a flight bundle on each anomaly; ``heartbeat`` pings a
shared directory (``parallel/heartbeat.py FileHeartbeat``) and a monitor
thread flags silent peers (``on_peer_stall``, ``stalled_peers``,
``heartbeat.missed``). The loop's ``ingest``, ``stage`` and ``step``
spans feed ``observability/spans.py``.

The reference's step is a function of a state tree; the port's state is
the model and the optimizer, which the step updates in place, so
``Trainer`` takes them and the loss function instead of a step function.

``sparse_tables`` is DownpourWorker's cycle (ref: ``trainer.py:716``):
each step pulls every table's rows for its ids, passes ``(rows, inv)``
per table after the batch to the loss, and after the optimizer's step
pushes each table's row gradient.

Not ported, and refused when set: the coordination-service heartbeat
transport (``heartbeat_transport="kv"``, ``heartbeat_kv_client``) and
``mesh_plan``.
"""

import dataclasses
import queue
import signal
import threading
import time

import numpy as np
import torch

from paddle_tpu_torch.core import random as _random
from paddle_tpu_torch.core.device import resolve_device
from paddle_tpu_torch.core.enforce import enforce
from paddle_tpu_torch.data.loader import _collate
from paddle_tpu_torch.observability import flight as _flight
from paddle_tpu_torch.observability import metrics as _metrics
from paddle_tpu_torch.observability import trace as _trace
from paddle_tpu_torch.observability.spans import span
from paddle_tpu_torch.testing.chaos import fault_point

# "rescheduleable interruption" exit status (BSD EX_TEMPFAIL)
PREEMPTED_EXIT_CODE = 75

#: the reference's flag default (``trainer_ingest_fail_fast``)
INGEST_FAIL_FAST = True


class Preempted(SystemExit):
    """Raised out of :meth:`Trainer.train` after a preemption signal
    triggered a final checkpoint at the step boundary; a script that lets
    it propagate exits with :data:`PREEMPTED_EXIT_CODE`."""

    def __init__(self, step, signum=None):
        super().__init__(PREEMPTED_EXIT_CODE)
        self.step = step
        self.signum = signum

    def __str__(self):
        return (f"preempted by signal {self.signum} at step {self.step} "
                "(checkpoint saved)")


@dataclasses.dataclass
class TrainerConfig:
    """ref: ``trainer.py:59``."""

    num_ingest_threads: int = 2
    channel_capacity: int = 8
    prefetch: bool = True          # collate batch t+1 during step t
    log_every: int = 0             # 0 = silent
    max_steps: int = None          # None = drain the dataset
    # liveness: None = on when train(num_workers > 1) and a heartbeat_dir
    # is given
    heartbeat: bool = None
    heartbeat_transport: str = "file"  # "kv" is not ported
    heartbeat_dir: str = None      # the directory every worker reaches
    heartbeat_timeout_s: float = None   # None: heartbeat.TIMEOUT_S
    heartbeat_interval_s: float = None  # None: heartbeat.INTERVAL_S
    heartbeat_kv_client: object = None  # not ported
    on_peer_stall: object = None   # (worker, age_s) -> None
    checkpoint_dir: str = None     # None = checkpointing off
    checkpoint_every: int = 0      # steps between saves (0 = off)
    resume: bool = True            # restore the newest checkpoint first
    handle_preemption: bool = False
    preemption_signals: tuple = None  # default (SIGTERM, SIGINT)
    telemetry: object = None       # TelemetryConfig; None: the setting
    watchdog: object = None        # True / WatchdogConfig; None: setting
    mesh_plan: object = None       # not ported
    guardian: object = None        # True or a GuardianConfig
    ingest_fail_fast: bool = INGEST_FAIL_FAST

    def check_ported(self):
        """Raise NotImplementedError for any field set to a value the port
        does not implement: the KV heartbeat transport and a mesh plan."""
        enforce(self.heartbeat_transport in ("file", "kv"),
                "heartbeat_transport must be 'file' or 'kv', got "
                f"{self.heartbeat_transport!r}")
        for name, unported in (
                ("heartbeat_transport", self.heartbeat_transport == "kv"),
                ("heartbeat_kv_client", self.heartbeat_kv_client is not None),
                ("mesh_plan", self.mesh_plan is not None)):
            if unported:
                raise NotImplementedError(
                    f"TrainerConfig.{name} is not ported to "
                    "paddle_tpu_torch")


class _EndOfData:
    pass


_EOD = _EndOfData()


class Trainer:
    """Train ``model`` with ``optimizer`` (an optimizer of the port, or a
    wrapper: ``amp.decorate``, ``Lookahead``, ``RecomputeOptimizer``) on
    ``loss_fn(model, *batch)`` over a dataset.

    dataset: anything with ``.readers(n)`` or ``.reader()`` returning a
    callable that yields batches (tuples of numpy arrays), or such a
    callable; ``.seek(step)`` makes it resumable and replayable.
    ``device`` is where batches are staged; it must hold the model.

    sparse_tables: ``[(table, ids_fn), ...]``, each table a host tier
    (``HostTable``: ``pull(ids, device) -> (rows, uniq)`` and
    ``push(uniq, row_grad)``) and ``ids_fn(batch)`` its ids in the host
    batch. The loss is then ``loss_fn(model, *batch, rows_1, inv_1, ...)``
    with each ``rows`` a leaf ``[k, D]`` that requires grad and ``inv``
    (``np.searchsorted(uniq, ids.reshape(-1))``) on the device; the
    tables take no checkpoint, as in the reference."""

    def __init__(self, model, optimizer, loss_fn, config=None,
                 sparse_tables=None, device="cuda"):
        self.sparse_tables = list(sparse_tables or [])
        self.cfg = config or TrainerConfig()
        self.cfg.check_ported()
        self.device = resolve_device(device)
        enforce(all(p.device.type == self.device.type
                    for p in model.parameters()),
                f"the model's parameters are not on {self.device}")
        self.model = model
        self.optimizer = optimizer
        self.loss_fn = loss_fn
        self.history = []
        self.guardian = None     # TrainGuardian after train() when armed
        self.telemetry = None    # StepTelemetry after train() when on
        self.watchdog = None     # Watchdog after train() when on
        self._ingest_threads = []

    # -- the state a checkpoint holds --------------------------------------
    def _named(self):
        return dict(self.model.named_parameters())

    def state(self):
        """``{"params": {name: tensor}, "opt": <optimizer state>,
        "buffers": {name: tensor}}``, the live tensors (a checkpoint
        copies them)."""
        named = self._named()
        return {"params": named, "opt": self.optimizer.state_tree(named),
                "buffers": dict(self.model.named_buffers())}

    @torch.no_grad()
    def load_state(self, state):
        """Copy a state of :meth:`state`'s form into the model and the
        optimizer; a state without ``"buffers"`` leaves the buffers."""
        named = self._named()
        for name, p in named.items():
            p.copy_(state["params"][name].to(p.device))
        self.optimizer.load_state_tree(named, state["opt"])
        buffers = state.get("buffers") or {}
        for name, b in self.model.named_buffers():
            if name in buffers:
                b.copy_(buffers[name].to(b.device))

    def _generators(self):
        return _random.step_generators(self.model, self.optimizer)

    # -- DataFeed channel --------------------------------------------------
    def _start_ingest(self, readers, on_error=None):
        chan = queue.Queue(maxsize=self.cfg.channel_capacity)
        counts = {"live": len(readers)}
        lock = threading.Lock()
        errors = []
        stop = threading.Event()

        def put(item):
            while not stop.is_set():
                try:
                    chan.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def work(reader):
            try:
                for item in reader():
                    fault_point("trainer.ingest")
                    if not put(item):
                        return  # trainer stopped early (max_steps)
            except BaseException as e:    # noqa: B036 - raised by train()
                # a dead reader is never silent: counted, alerted, and
                # raised by train() (at once under ingest_fail_fast, else
                # at the end)
                errors.append(e)
                _metrics.counter(
                    "trainer.ingest_errors",
                    "Ingest reader threads that died, by exception "
                    "type.").inc(reason=type(e).__name__)
                if on_error is not None:
                    on_error(e)
            finally:
                with lock:
                    counts["live"] -= 1
                    if counts["live"] == 0:
                        put(_EOD)

        threads = [threading.Thread(target=work, args=(r,), daemon=True)
                   for r in readers]
        for t in threads:
            t.start()
        self._ingest_threads = threads
        return chan, stop, errors

    def _split_readers(self, dataset):
        n = self.cfg.num_ingest_threads
        if hasattr(dataset, "readers"):
            return dataset.readers(n)
        if hasattr(dataset, "reader"):
            return [dataset.reader()]
        return [dataset]

    # -- preemption --------------------------------------------------------
    def _install_preemption_handler(self):
        """Signal handlers that request a stop at the next step boundary.
        Returns (requested: dict, restore: callable)."""
        requested = {"signum": None}
        if not self.cfg.handle_preemption:
            return requested, lambda: None
        sigs = self.cfg.preemption_signals or (signal.SIGTERM, signal.SIGINT)
        prev = {}

        def on_signal(signum, frame):
            requested["signum"] = signum

        try:
            for s in sigs:
                prev[s] = signal.signal(s, on_signal)
        except ValueError:
            print("[trainer] WARNING: handle_preemption requested off the "
                  "main thread; preemption signals will not be trapped")
            return requested, lambda: None

        def restore():
            for s, h in prev.items():
                signal.signal(s, h)

        return requested, restore

    # -- liveness ----------------------------------------------------------
    def _start_heartbeat(self, num_workers=None, worker_id=None):
        """Ping ``<heartbeat_dir>/worker_<id>.hb`` (at most once an
        interval) and scan the peers' files from a monitor thread,
        flagging each RUNNING peer silent past the timeout once
        (``on_peer_stall(worker, age_s)``, ``stalled_peers``,
        ``heartbeat.missed``). Returns ``(ping, finish)``; ``finish(ok)``
        writes the done marker on a clean exit only (a crashed worker
        must look stalled to its peers). No-ops when off."""
        cfg = self.cfg
        nw = num_workers if num_workers is not None else 1
        enabled = cfg.heartbeat
        if enabled is None:
            enabled = nw > 1 and cfg.heartbeat_dir is not None
        if not enabled:
            return (lambda: None), (lambda ok=True: None)
        enforce(cfg.heartbeat_dir is not None,
                "TrainerConfig(heartbeat=True) requires heartbeat_dir (a "
                "directory every worker can reach)")
        from paddle_tpu_torch.parallel import heartbeat as _hb
        wid = worker_id if worker_id is not None else 0
        timeout = (cfg.heartbeat_timeout_s if cfg.heartbeat_timeout_s
                   is not None else _hb.TIMEOUT_S)
        interval = (cfg.heartbeat_interval_s if cfg.heartbeat_interval_s
                    is not None else _hb.INTERVAL_S)
        hb = _hb.FileHeartbeat(cfg.heartbeat_dir, wid)
        hb.ping()
        last_ping = [time.monotonic()]

        def ping():
            # throttled: the monitor samples once an interval anyway
            now = time.monotonic()
            if now - last_ping[0] >= min(interval, timeout / 4):
                hb.ping()
                last_ping[0] = now

        stop = threading.Event()
        stalled = self.stalled_peers = set()

        def monitor():
            while not stop.wait(interval):
                scan = _hb.FileHeartbeat.scan(cfg.heartbeat_dir, nw, timeout)
                for w, (st, age) in scan.items():
                    if w != wid and st == _hb.STALLED and w not in stalled:
                        stalled.add(w)
                        _metrics.counter("heartbeat.missed").inc(worker=w)
                        if cfg.on_peer_stall is not None:
                            cfg.on_peer_stall(w, age)
                        else:
                            print(f"[trainer] WARNING: worker {w} silent "
                                  f"for {age:.1f}s (> {timeout}s)")

        t = threading.Thread(target=monitor, daemon=True,
                             name="trainer-heartbeat")
        t.start()

        def finish(ok=True):
            if ok:
                hb.complete()
            stop.set()
            t.join(timeout=5)

        return ping, finish

    # -- observability -------------------------------------------------------
    def _start_telemetry(self):
        """A StepTelemetry when ``TrainerConfig.telemetry`` is given or the
        ``telemetry`` setting is on (kept on :attr:`telemetry`); None
        means no telemetry work in the loop."""
        from paddle_tpu_torch.observability import telemetry as _tele
        tcfg = self.cfg.telemetry
        if tcfg is None and not _tele.setting("telemetry"):
            return None
        tele = _tele.StepTelemetry(tcfg if tcfg is not None
                                   else _tele.TelemetryConfig())
        self.telemetry = tele
        return tele if tele.enabled else None

    def _start_watchdog(self, tele):
        """A Watchdog when ``TrainerConfig.watchdog`` (or the setting)
        asks for one; its events ride the telemetry's RunLog, and each
        one dumps a flight bundle."""
        from paddle_tpu_torch.observability.watchdog import maybe_watchdog
        log = getattr(tele, "_log", None)
        wd = maybe_watchdog(self.cfg.watchdog, run_log=log,
                            action=lambda event: self._on_anomaly(event,
                                                                  log))
        self.watchdog = wd
        return wd

    def _on_anomaly(self, event, run_log=None):
        """A watchdog anomaly becomes a flight bundle: the metrics
        snapshot, the event ring (the loop's spans linked to the run's
        trace context) and the telemetry RunLog's tail, with the
        Trainer's config. Nothing when recording is off."""
        fl = _flight.recorder()
        if fl is None:
            return
        fl.note_event("anomaly", **{k: v for k, v in event.items()
                                    if k not in ("event", "t")})
        _flight.dump_bundle(
            reason=str(event.get("anomaly", "anomaly")),
            run_logs=(run_log,) if run_log is not None else (),
            config=dict(trainer_config=repr(self.cfg)),
            extra=dict(anomaly=event))

    def _stage(self, batch):
        """Each array of the batch on the device: pinned host memory,
        copied without blocking the host on the default stream (torch
        keeps the pinned block until the copy lands)."""
        def put(a):
            t = torch.as_tensor(a)
            if self.device.type == "cuda":
                return t.pin_memory().to(self.device, non_blocking=True)
            return t
        return tuple(put(a) for a in batch)

    def _sparse_step(self, staged, host):
        """DownpourWorker's cycle (ref: ``trainer.py:716``): pull each
        table's rows for ``ids_fn(host)``, step through them, push each
        table's row gradient. Returns the loss."""
        pulls, extra = [], []
        for table, ids_fn in self.sparse_tables:
            ids = np.asarray(ids_fn(host))
            rows, uniq = table.pull(ids, device=self.device)
            rows.requires_grad_(True)
            inv = np.searchsorted(uniq, ids.reshape(-1))
            extra += [rows, self._stage((inv,))[0]]
            pulls.append((table, uniq, rows))
        loss = self.optimizer.minimize(self.model, self.loss_fn, *staged,
                                       *extra)
        for table, uniq, rows in pulls:
            table.push(uniq, rows.grad)
        return loss

    def train(self, dataset, batch_size=None, num_workers=None,
              worker_id=None):
        """Drain the dataset (or ``max_steps``); returns stats.

        With ``batch_size`` the readers yield samples and the loop
        collates ``batch_size`` of them per step off the merged channel
        (dropping the last partial batch). ``num_workers`` and
        ``worker_id`` name this worker among the processes that share
        ``heartbeat_dir``."""
        cfg = self.cfg
        step = 0
        guard = None
        if cfg.guardian:
            from paddle_tpu_torch.static.guardian import (GuardianConfig,
                                                          TrainGuardian)
            enforce(not self.sparse_tables,
                    "TrainerConfig.guardian does not support "
                    "sparse_tables (the sparse step's pull/push cycle "
                    "has host-side state the skip-apply gate cannot "
                    "contain)")
            guard = TrainGuardian(
                cfg.guardian if isinstance(cfg.guardian, GuardianConfig)
                else None)
            self.guardian = guard
        gens = self._generators()
        ckpt_mgr = None
        if cfg.checkpoint_dir and cfg.checkpoint_every:
            from paddle_tpu_torch.io.checkpoint import CheckpointManager
            ckpt_mgr = CheckpointManager(
                cfg.checkpoint_dir, save_interval_steps=cfg.checkpoint_every)
            if cfg.resume:
                restored, at = ckpt_mgr.restore(self.state(),
                                                optional=("buffers",))
                if restored is not None:
                    self.load_state(restored)
                    step = int(at)
                    meta = ckpt_mgr.read_meta(step)
                    _random.set_state(gens, meta.get("rng"))
                    if guard is not None:
                        guard.load_state(meta.get("guardian"))
                    if hasattr(dataset, "seek"):
                        dataset.seek(step)
                    print(f"[trainer] resumed from step {step}")
            ckpt_mgr.reserve(self.state())
        start_step = step
        preempt, restore_signals = self._install_preemption_handler()
        tele = self._start_telemetry()
        if tele is not None and tele._log is not None:
            # clock anchor for the fleet-trace merge
            _trace.write_anchor(tele._log, role="trainer")
        wd = self._start_watchdog(tele)
        if guard is not None:
            guard.attach(run_log=getattr(tele, "_log", None), watchdog=wd)

        def on_ingest_error(e):
            if wd is not None:
                wd.alert("ingest_error", step, latch=False,
                         error=f"{type(e).__name__}: {e}"[:200])

        chan, stop, errors = self._start_ingest(
            self._split_readers(dataset), on_error=on_ingest_error)
        hb_ping, hb_finish = self._start_heartbeat(num_workers, worker_id)
        stall_ctr = _metrics.counter(
            "trainer.ingest_stall_s",
            "Wall time the device loop spent blocked on the ingest "
            "channel.")
        depth_gauge = _metrics.gauge(
            "trainer.channel_depth",
            "Ingest channel occupancy sampled at each dequeue.")
        stall_acc = {"t": 0.0}   # this step's ingest wait, for the watchdog

        def ckpt_meta():
            m = {"cursor": int(step), "rng": _random.get_state(gens)}
            if guard is not None:
                m["guardian"] = guard.state_dict()
            return m

        def get_item():
            tw0 = time.perf_counter()
            item = chan.get()
            dt = time.perf_counter() - tw0
            stall_ctr.inc(dt)
            stall_acc["t"] += dt
            depth_gauge.set(chan.qsize())
            return item

        def next_batch():
            if batch_size is None:
                item = get_item()
                return None if isinstance(item, _EndOfData) else item
            buf = []
            while len(buf) < batch_size:
                item = get_item()
                if isinstance(item, _EndOfData):
                    return None  # drop_last on the merged stream
                buf.append(item)
            return _collate(buf)

        def do_rollback():
            # restore the newest checkpoint strictly before the anomaly
            # episode and replay the stream to its cursor
            nonlocal step, chan, stop, errors
            enforce(ckpt_mgr is not None,
                    "guardian rollback requires checkpointing "
                    "(TrainerConfig.checkpoint_dir + checkpoint_every)")
            enforce(hasattr(dataset, "seek"),
                    "guardian rollback requires a seekable dataset "
                    "(dataset.seek(step)) to replay the stream")
            bound = guard.rollback_bound
            guard.begin_rollback(step, bound=bound)  # budget; may raise
            stop.set()
            for t in self._ingest_threads:
                t.join(timeout=10)
            ckpt_mgr.wait()                 # the queued saves land first
            cands = [s for s in ckpt_mgr.steps()
                     if bound is None or s <= bound]
            restored = at = None
            while cands:
                target = cands.pop()        # newest safe step first
                try:
                    restored, at = ckpt_mgr.restore(
                        self.state(), step=target, optional=("buffers",))
                    break
                except Exception as e:      # degrade to the previous step
                    print(f"[trainer] rollback: step {target} "
                          f"unrestorable ({type(e).__name__}: {e}); "
                          "degrading to the previous step")
            enforce(restored is not None,
                    "guardian rollback found no restorable checkpoint at "
                    "or before the anomaly")
            self.load_state(restored)
            step = int(at)
            # rewind the generators with the state; the guardian's window
            # and counters are not rewound (the replay walks the healthy
            # trajectory the window holds)
            _random.set_state(gens, ckpt_mgr.read_meta(step).get("rng"))
            guard.note_rollback_done(step)
            dataset.seek(step)
            chan, stop, errors = self._start_ingest(
                self._split_readers(dataset), on_error=on_ingest_error)
            print(f"[trainer] guardian rollback: restored step {step}, "
                  "stream replayed")

        t0 = time.perf_counter()
        loss = None
        clean = False
        preempted_sig = None
        # one trace context covers the loop: its spans link into it
        # through the flight ring, so an anomaly bundle shows where in
        # the step the run was
        scope = _trace.activate(_trace.TraceContext(
            f"{_trace.mint_run()}/train", span_id="train"))
        scope.__enter__()
        try:
            with span("ingest"):
                nxt = next_batch()
            first = True
            it_t = time.perf_counter()
            while nxt is not None:
                if cfg.max_steps is not None and step >= cfg.max_steps:
                    break
                if cfg.ingest_fail_fast and errors:
                    break    # a reader died: stop now, raise below
                with span("stage"):
                    staged = self._stage(nxt)
                host = nxt
                if cfg.prefetch:
                    with span("ingest"):
                        nxt = next_batch()
                if first and tele is not None and not self.sparse_tables:
                    tele.maybe_estimate_flops(self.loss_fn, self.model,
                                              *staged)
                first = False
                with span("step"):
                    fault_point("trainer.step")
                    if self.sparse_tables:
                        loss = self._sparse_step(staged, host)
                    elif guard is not None:
                        loss, applied = self.optimizer.minimize_gated(
                            guard.gate, self.model, self.loss_fn, *staged)
                    else:
                        loss = self.optimizer.minimize(
                            self.model, self.loss_fn, *staged)
                step += 1
                now = time.perf_counter()
                if tele is not None:
                    # the loss is parked, never read here
                    tele.on_step(step, staged, loss, self.model,
                                 wall_s=now - it_t)
                if wd is not None:
                    wd.tick(step, wall_s=now - it_t, stall_s=stall_acc["t"])
                stall_acc["t"] = 0.0
                it_t = now
                if guard is not None:
                    # parks this step's device scalars and judges the
                    # previous step's
                    act = guard.observe_step(step, loss, applied)
                    if act == "reread":
                        # drop the batch at the cursor, take the next one
                        with span("ingest"):
                            fresh = next_batch()
                        if cfg.prefetch or fresh is None:
                            nxt = fresh
                    elif act == "rollback":
                        do_rollback()
                        with span("ingest"):
                            nxt = next_batch()
                        it_t = time.perf_counter()
                        continue
                hb_ping()
                if preempt["signum"] is not None:
                    if ckpt_mgr is not None:
                        ckpt_mgr.save(step, self.state(), force=True,
                                      meta=ckpt_meta())
                        ckpt_mgr.wait()     # landed before Preempted
                    preempted_sig = preempt["signum"]
                    _metrics.counter("trainer.preempted").inc()
                    print(f"[trainer] preemption signal {preempted_sig}: "
                          f"checkpointed step {step}, exiting for resume")
                    break
                if ckpt_mgr is not None and (guard is None
                                             or guard.healthy()):
                    # no interval save while an anomaly episode is open,
                    # so the newest checkpoint is a good rollback target
                    if (ckpt_mgr.save(step, self.state(), meta=ckpt_meta())
                            and guard is not None):
                        guard.note_checkpoint(step)
                if cfg.log_every and step % cfg.log_every == 0:
                    lv = float(loss)
                    self.history.append((step, lv))
                    print(f"[trainer] step {step} loss {lv:.6f}")
                if not cfg.prefetch:
                    with span("ingest"):
                        nxt = next_batch()
            clean = preempted_sig is None
        finally:
            scope.__exit__(None, None, None)
            stop.set()  # release producers even when the step raises
            restore_signals()
            hb_finish(clean)    # no done marker unless the run ended well
            try:
                if ckpt_mgr is not None:
                    ckpt_mgr.close()
            finally:
                if guard is not None:
                    guard.flush_trailing()
                if tele is not None:
                    extra = {"steps": step,
                             "preempted": preempted_sig is not None}
                    if guard is not None:
                        extra.update(nonfinite_skips=guard.skips,
                                     loss_spikes=guard.spikes,
                                     rollbacks=guard.rollbacks)
                    tele.finish(extra)
        if preempted_sig is not None:
            raise Preempted(step, preempted_sig)
        run_steps = step - start_step
        if errors:
            raise RuntimeError(
                f"ingestion thread failed after {run_steps} steps "
                f"(total step {step})") from errors[0]
        wall = time.perf_counter() - t0
        return {"steps": step, "run_steps": run_steps, "wall_s": wall,
                "steps_per_s": run_steps / wall if wall > 0 else 0.0,
                "final_loss": float(loss) if loss is not None else None}


def train_from_dataset(model, optimizer, loss_fn, dataset, config=None,
                       batch_size=None, device="cuda", sparse_tables=None):
    """Functional one-call form (ref: executor.py:1107)."""
    return Trainer(model, optimizer, loss_fn, config, sparse_tables,
                   device=device).train(dataset, batch_size=batch_size)
