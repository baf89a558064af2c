"""Step telemetry: per-step run records for the Trainer, with no wait on
the step just dispatched (ref: ``paddle_tpu/observability/telemetry.py``).

The Trainer hands :class:`StepTelemetry` each step's batch, loss and
wall time; every ``every_n_steps`` steps it emits a record to a RunLog:
wall time, tokens/s, MFU (``perf.cost_flops`` over ``perf.peak_flops``),
the loss, an optional gradient norm and device memory.

The hot-path rule: the loss of the step just dispatched is never read.
At an emission step its loss is parked: on the card a non-blocking copy
into pinned host memory on the current stream, with a CUDA event
recorded after it; on the CPU the tensor itself. The parked loss is read
at the next emission (after its event), by which time it is at least one
interval old; records therefore trail by one interval, and
:meth:`StepTelemetry.finish` flushes the last one and writes a final
record with the metrics registry's snapshot, the run's step-time
statistics and the span table.

The reference's ``telemetry``, ``telemetry_run_log``,
``telemetry_every_n`` and ``metrics_port`` flags become module settings
with the flags' defaults (off, no file, 1, 0), each also read from
``PT_FLAGS_<name>`` at import; :func:`configure` changes them.
"""

import dataclasses
import time

import torch

from paddle_tpu_torch.core.settings import env_default
from paddle_tpu_torch.observability import metrics as _metrics
from paddle_tpu_torch.observability import perf as _perf
from paddle_tpu_torch.observability.runlog import RunLog
from paddle_tpu_torch.observability.spans import span_summary

_SETTINGS = {
    "telemetry": env_default("telemetry", False),
    "telemetry_run_log": env_default("telemetry_run_log", ""),
    "telemetry_every_n": env_default("telemetry_every_n", 1),
    "metrics_port": env_default("metrics_port", 0),
}


def configure(**settings):
    """Set telemetry defaults (the keys of :data:`_SETTINGS`); None leaves
    a setting as it is. Returns the settings."""
    for key, val in settings.items():
        if key not in _SETTINGS:
            raise KeyError(f"unknown telemetry setting {key!r}")
        if val is not None:
            _SETTINGS[key] = val
    return dict(_SETTINGS)


def setting(name):
    """The current value of one telemetry setting."""
    return _SETTINGS[name]


@dataclasses.dataclass
class TelemetryConfig:
    """Trainer step telemetry. ``None`` fields resolve from the module
    settings (and so from ``PT_FLAGS_telemetry``,
    ``PT_FLAGS_telemetry_run_log``, ``PT_FLAGS_telemetry_every_n`` and
    ``PT_FLAGS_metrics_port``)."""

    enabled: bool = None          # None -> setting "telemetry"
    run_log: str = None           # JSONL path; None -> setting ('' = none)
    every_n_steps: int = None     # None -> setting "telemetry_every_n"
    rotate_records: int = 0       # RunLog rotation (0 = never)
    flops_per_step: float = None  # known FLOPs; skips the count
    estimate_flops: bool = True   # count them when unknown
    tokens_fn: object = None      # batch -> tokens a step (None = infer)
    grad_norm_fn: object = None   # model -> device scalar (optional)
    metrics_port: int = None      # /metrics exporter; None -> setting,
    #                               0 = off

    def resolve(self):
        """A copy with every None filled from the current settings."""
        c = dataclasses.replace(self)
        if c.enabled is None:
            c.enabled = bool(_SETTINGS["telemetry"])
        if c.run_log is None:
            c.run_log = _SETTINGS["telemetry_run_log"] or None
        if c.every_n_steps is None:
            c.every_n_steps = int(_SETTINGS["telemetry_every_n"])
        c.every_n_steps = max(1, int(c.every_n_steps))
        if c.metrics_port is None:
            c.metrics_port = int(_SETTINGS["metrics_port"])
        return c


def default_tokens(batch):
    """Tokens a step from the batch: the first array of 2 or more
    dimensions gives batch x seq; else the first array's leading size
    (examples stand in for tokens); else 0."""
    arrays = [a for a in batch if getattr(a, "shape", None)]
    for a in arrays:
        if len(a.shape) >= 2:
            return int(a.shape[0]) * int(a.shape[1])
    for a in arrays:
        if len(a.shape) >= 1:
            return int(a.shape[0])
    return 0


def _park(t):
    """A copy of a 0-d device scalar that a later host read may take
    without waiting on anything dispatched after it: ``(host tensor,
    event)``; on the CPU ``(t, None)``."""
    if t is None:
        return None
    t = t.detach()
    if not t.is_cuda:
        return t, None
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    event = torch.cuda.Event()
    event.record()
    return host, event


def _read(parked):
    if parked is None:
        return None
    host, event = parked
    if event is not None:
        event.synchronize()
    return float(host)


class StepTelemetry:
    """Per-step records to a RunLog (and :attr:`records` in memory).

        tele = StepTelemetry(TelemetryConfig(enabled=True, run_log=p))
        tele.maybe_estimate_flops(loss_fn, model, *batch)    # once
        for ...:
            loss = optimizer.minimize(model, loss_fn, *batch)
            tele.on_step(step, batch, loss, model, wall_s)
        tele.finish({"steps": step})
    """

    def __init__(self, config=None):
        self.cfg = (config or TelemetryConfig()).resolve()
        self.enabled = bool(self.cfg.enabled)
        self.records = []
        self._log = None
        if self.enabled and self.cfg.run_log:
            self._log = RunLog(self.cfg.run_log,
                               rotate_records=self.cfg.rotate_records)
        self._flops = self.cfg.flops_per_step
        self._pending = None     # (step, wall_s, tokens, loss, gnorm)
        self._hist = _metrics.histogram(
            "trainer.step_s", "Per-step wall time seen by the Trainer.")
        # this run's own step times (the registry's histogram is
        # process-wide)
        self._run_hist = _metrics.Histogram("trainer.step_s")
        self._finished = False
        self._metrics_server = None
        if self.enabled and self.cfg.metrics_port:
            from paddle_tpu_torch.observability.exporter import \
                start_metrics_server
            self._metrics_server = start_metrics_server(
                self.cfg.metrics_port)

    @property
    def flops_per_step(self):
        return self._flops

    def maybe_estimate_flops(self, loss_fn, model, *batch):
        """Count the FLOPs a step once (``perf.cost_flops``), unless the
        config gave them. A failed count gives records with mfu None,
        never an error in the loop."""
        if not self.enabled or self._flops is not None:
            return
        if not self.cfg.estimate_flops:
            self._flops = 0.0
            return
        self._flops = _perf.cost_flops(loss_fn, model, *batch)

    def on_step(self, step, batch, loss, model=None, wall_s=None):
        """Record one dispatched step. Its loss is parked, never read
        here."""
        if not self.enabled:
            return
        if wall_s is not None:
            self._hist.observe(wall_s)
            self._run_hist.observe(wall_s)
        if step % self.cfg.every_n_steps != 0:
            return
        self._flush_pending(at_step=step)
        tokens = (self.cfg.tokens_fn(batch) if self.cfg.tokens_fn
                  else default_tokens(batch))
        gnorm = (self.cfg.grad_norm_fn(model)
                 if self.cfg.grad_norm_fn is not None else None)
        self._pending = (int(step), wall_s, tokens, _park(loss),
                         _park(gnorm))

    def _flush_pending(self, at_step=None):
        """Emit the parked record; from :meth:`on_step` its step is
        strictly older than ``at_step``."""
        if self._pending is None:
            return
        step, wall_s, tokens, loss, gnorm = self._pending
        self._pending = None
        rec = {"step": step, "time": time.time(), "wall_s": wall_s}
        rec["tokens_per_s"] = (tokens / wall_s if tokens and wall_s
                               else None)
        rec["mfu"] = _perf.mfu(self._flops, wall_s)
        rec["loss"] = _read(loss)
        rec["grad_norm"] = _read(gnorm)
        rec["memory"] = _perf.device_memory_stats()
        self._write(rec)

    def _write(self, rec):
        self.records.append(rec)
        if self._log is not None:
            self._log.write(rec)

    def finish(self, extra=None):
        """Flush the trailing record and write the final one: the metrics
        registry's counters, gauges and histograms, this run's step-time
        statistics and the span table, plus ``extra``."""
        if not self.enabled or self._finished:
            return
        self._finished = True
        self._flush_pending()
        snap = _metrics.snapshot()
        rec = {"final": True, "time": time.time(),
               "counters": snap.get("counters", {}),
               "gauges": snap.get("gauges", {}),
               "histograms": snap.get("histograms", {}),
               "step_time": self._run_hist.stats(),
               "spans": span_summary()}
        if extra:
            rec.update(extra)
        self._write(rec)
        if self._log is not None:
            self._log.close()
        if self._metrics_server is not None:
            self._metrics_server.stop()
            self._metrics_server = None

    def close(self):
        self.finish()
