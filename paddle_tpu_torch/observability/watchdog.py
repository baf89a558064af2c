"""Runtime anomaly watchdog: rolling-window detection of the ways a
healthy run goes quietly bad (ref: ``paddle_tpu/observability/
watchdog.py``, standard library only).

It reads the timings the serving engine already takes (no device read)
and latches structured anomaly events into ``watchdog.anomalies{kind}``
and the RunLog:

  slow_step         a step's wall time > slow_factor x the rolling median
  ingest_stall      one step waited > stall_s on an ingest channel
  retrace           ``jit.retraces`` grew past the warm-up steps
  goodput_collapse  serve.goodput < goodput_min once enough requests
                    retired

``alert()`` feeds kinds detected elsewhere (ingest_error, loss_spike)
through the same latch, counter, RunLog and mitigation path.

A level-triggered kind fires once when its condition appears and re-arms
when it clears; retrace fires on every observed growth.

The port runs no jit, so nothing adds to ``jit.retraces`` and no engine
of the port registers a ``watch_jit`` probe: the API and the retrace
check on the counter are kept so a caller's own probe still works.

The reference's flags become :class:`WatchdogConfig` defaults (the
``watchdog*`` flags': window 64, slow_factor 3.0, stall_s 1.0,
goodput_min 0.5), and its ``watchdog`` flag (off) a module setting that
a config's None reads: change it with :func:`configure`.
"""

import collections
import dataclasses
import threading
import time

from paddle_tpu_torch.observability import metrics as _metrics
from paddle_tpu_torch.observability.catalog import help_for as _help

_SETTINGS = {"watchdog": False}


def configure(watchdog=None):
    """Set whether a loop whose config leaves ``watchdog`` None runs one;
    None leaves the setting as it is. Returns the settings."""
    if watchdog is not None:
        _SETTINGS["watchdog"] = bool(watchdog)
    return dict(_SETTINGS)


KINDS = ("slow_step", "ingest_stall", "retrace", "goodput_collapse",
         "ingest_error", "loss_spike")


@dataclasses.dataclass
class WatchdogConfig:
    window: int = 64            # steps in the rolling median
    slow_factor: float = 3.0    # slow_step threshold over the median
    stall_s: float = 1.0        # ingest_stall threshold
    goodput_min: float = 0.5    # goodput_collapse threshold
    min_samples: int = 8        # the median needs this many steps first
    warmup_steps: int = 2       # retraces at or below this step are the
    #                             first compile, not an anomaly
    min_retired: int = 8        # goodput needs this many retirements

    def resolve(self):
        c = dataclasses.replace(self)
        c.window = max(2, int(c.window))
        return c


class Watchdog:
    """One per run loop. Feed it ``tick()`` once a step; read
    ``anomalies`` (structured dicts) or ``watchdog.anomalies{kind}``."""

    def __init__(self, config=None, run_log=None, registry=None,
                 clock=time.time, action=None):
        self.cfg = (config or WatchdogConfig()).resolve()
        self._reg = (registry if registry is not None
                     else _metrics.registry())
        self._run_log = run_log
        self._clock = clock
        self._action = action       # mitigation callback: (event) -> None
        # the lock covers detector state only; the mitigation callback
        # runs after it is released, so the watchdog never holds it while
        # re-entering the loop it watches
        self._lock = threading.Lock()
        self._steps = collections.deque(maxlen=self.cfg.window)
        self._latched = set()
        self._watched = {}          # fn name -> [probe, last cache size]
        self._retraces_seen = 0     # last-seen jit.retraces total
        self.anomalies = []

    def watch_jit(self, name, fn):
        """Poll ``fn._cache_size()`` each tick; growth past one entry
        counts ``jit.retraces{fn=name}``. Callables without the probe are
        ignored (every callable of the port)."""
        probe = getattr(fn, "_cache_size", None)
        if callable(probe):
            with self._lock:
                self._watched[str(name)] = [probe, None]
        return self

    def tick(self, step, wall_s=None, stall_s=None, goodput=None,
             retired=0):
        """One scheduling round: run every detector this loop feeds; an
        argument left None skips its detector."""
        cfg = self.cfg
        fired = []
        with self._lock:
            if wall_s is not None:
                median = self._median()
                if (median is not None
                        and wall_s > cfg.slow_factor * median):
                    self._fire(fired, "slow_step", step, wall_s=wall_s,
                               median_s=median)
                else:
                    self._clear("slow_step")
                self._steps.append(float(wall_s))
            if stall_s is not None:
                if stall_s > cfg.stall_s:
                    self._fire(fired, "ingest_stall", step,
                               stall_s=stall_s)
                else:
                    self._clear("ingest_stall")
            self._poll_jit()
            self._check_retraces(step, fired)
            if goodput is not None and retired >= cfg.min_retired:
                if goodput < cfg.goodput_min:
                    self._fire(fired, "goodput_collapse", step,
                               goodput=goodput, retired=retired)
                else:
                    self._clear("goodput_collapse")
        for event in fired:
            self._dispatch(event)

    def alert(self, kind, step, latch=True, **detail):
        """Latch an anomaly detected elsewhere through the same counter,
        RunLog and dispatch path. True when a new event fired."""
        fired = []
        with self._lock:
            self._fire(fired, str(kind), step, latch=latch, **detail)
        for event in fired:
            self._dispatch(event)
        return bool(fired)

    def resolve(self, kind):
        """Re-arm a latched kind fed through :meth:`alert`."""
        with self._lock:
            self._clear(str(kind))

    def _median(self):
        if len(self._steps) < self.cfg.min_samples:
            return None
        vals = sorted(self._steps)
        n = len(vals)
        mid = n // 2
        return vals[mid] if n % 2 else 0.5 * (vals[mid - 1] + vals[mid])

    def _poll_jit(self):
        ctr = self._reg.counter("jit.retraces", _help("jit.retraces"))
        for name, slot in self._watched.items():
            probe, last = slot
            try:
                size = int(probe())
            except Exception:
                continue
            if last is not None and size > max(last, 1):
                ctr.inc(size - max(last, 1), fn=name)
            slot[1] = size

    def _check_retraces(self, step, fired):
        ctr = self._reg.get("jit.retraces")
        total = ctr.total() if ctr is not None else 0
        grew = total - self._retraces_seen
        self._retraces_seen = total
        if grew > 0 and step > self.cfg.warmup_steps:
            self._fire(fired, "retrace", step, new_retraces=grew,
                       latch=False)

    def _fire(self, fired, kind, step, latch=True, **detail):
        """Record one anomaly (the caller holds the lock) and queue it on
        ``fired`` for dispatch after the lock is released."""
        if latch:
            if kind in self._latched:
                return
            self._latched.add(kind)
        event = {"anomaly": kind, "step": int(step),
                 "time": self._clock(), **detail}
        self.anomalies.append(event)
        self._reg.counter("watchdog.anomalies",
                          _help("watchdog.anomalies")).inc(kind=kind)
        if self._run_log is not None:
            self._run_log.write(event)
        fired.append(event)

    def _dispatch(self, event):
        if self._action is not None:
            # mitigation must never take down the loop it protects
            try:
                self._action(event)
            except Exception as e:
                if self._run_log is not None:
                    self._run_log.write({"anomaly_action_error":
                                         f"{type(e).__name__}: {e}"[:200]})

    def _clear(self, kind):
        self._latched.discard(kind)


def maybe_watchdog(setting, run_log=None, registry=None, action=None):
    """A config's ``watchdog`` field as a Watchdog or None: a
    WatchdogConfig is used as is, True builds the defaults, False builds
    none and None follows the ``watchdog`` setting (off by default).
    ``action`` is called with each fired event."""
    if setting is None:
        setting = _SETTINGS["watchdog"]
    if not setting:
        return None
    cfg = setting if isinstance(setting, WatchdogConfig) else None
    return Watchdog(cfg, run_log=run_log, registry=registry, action=action)
