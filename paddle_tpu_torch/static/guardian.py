"""Training guardian — numerical fault containment for long runs (ref:
``paddle_tpu/static/guardian.py``).

  containment         the optimizer's gated step (``optimizer.Gate``):
                      every new parameter and slot is computed first,
                      then committed only where ``isfinite(loss) &
                      isfinite(global update norm)`` holds on the device,
                      so a non-finite step changes nothing (bit for bit)
                      and its ``applied`` flag stays on the device. The
                      reference gates a functional state with
                      ``jnp.where``; the port's state is updated in place,
                      so the gate sits inside the optimizer's step, before
                      any copy.
  loss-spike detector :meth:`TrainGuardian.observe_step` keeps a rolling
                      window of healthy losses; a finite loss above
                      ``spike_factor`` x the rolling median latches a
                      spike (once per episode, re-armed by a healthy
                      step).
  mitigation ladder   consecutive anomalous steps escalate: 1 skip, 2
                      re-read the batch, 3+ roll back to the last good
                      checkpoint and replay the stream to its cursor.
                      Rollbacks draw on a :class:`RetryBudget`; when it is
                      spent :class:`TrainingDiverged` is raised.

Trailing fetch: ``observe_step(step, ...)`` parks the step's device
scalars and processes those parked one step earlier; reading them on the
host (``.item()``) waits only for that earlier step, never for the one
just dispatched.

:meth:`TrainGuardian.attach` wires the run's observability plane: the
guardian's records (each skip, spike, rollback) go to the attached
RunLog, or to :attr:`TrainGuardian.log` when none is attached; a latched
loss spike alerts the attached watchdog; and the registry counts
``trainer.nonfinite_skips``, ``trainer.loss_spikes`` and
``trainer.rollbacks``.
"""

import collections
import dataclasses
import math

from paddle_tpu_torch.core.retry import RetryBudget, RetryPolicy
from paddle_tpu_torch.observability import metrics as _metrics
from paddle_tpu_torch.observability.catalog import help_for as _help
from paddle_tpu_torch.optimizer.optimizers import Gate
from paddle_tpu_torch.testing.chaos import fault_point

#: the reference's flag defaults (``trainer_spike_factor``,
#: ``trainer_rollback_budget``)
SPIKE_FACTOR = 10.0
ROLLBACK_BUDGET = 3


class TrainingDiverged(RuntimeError):
    """The mitigation ladder exhausted its rollback budget."""


@dataclasses.dataclass
class GuardianConfig:
    spike_factor: float = SPIKE_FACTOR
    spike_window: int = 64       # rolling-median window (healthy losses)
    min_samples: int = 8         # median needs this many healthy losses
    rollback_budget: int = ROLLBACK_BUDGET
    check_update_norm: bool = True  # gate on the global update norm too
    scaler_state_fn: object = None  # amp.LossScaler metrics: not ported

    def resolve(self):
        if self.scaler_state_fn is not None:
            raise NotImplementedError(
                "GuardianConfig.scaler_state_fn: the fp16 LossScaler is not "
                "ported")
        c = dataclasses.replace(self)
        c.spike_factor = SPIKE_FACTOR if c.spike_factor is None else float(
            c.spike_factor)
        c.rollback_budget = (ROLLBACK_BUDGET if c.rollback_budget is None
                             else int(c.rollback_budget))
        c.spike_window = max(2, int(c.spike_window))
        c.min_samples = max(2, int(c.min_samples))
        return c


class TrainGuardian:
    """One instance per training run. The Trainer steps through
    ``optimizer.minimize_gated(guardian.gate, ...)``, feeds
    :meth:`observe_step` once per step and acts on the returned
    mitigation ("reread" / "rollback" / None)."""

    def __init__(self, config=None):
        self.cfg = (config or GuardianConfig()).resolve()
        self.gate = Gate(check_update_norm=self.cfg.check_update_norm)
        self._budget = RetryBudget(
            RetryPolicy(max_attempts=self.cfg.rollback_budget + 1),
            "trainer.rollback")
        self._window = collections.deque(maxlen=self.cfg.spike_window)
        self._pending = None        # (step, loss, applied) device scalars
        self._spike_latched = False
        self.episode = 0            # consecutive anomalous steps
        self.episode_start = None   # step of the episode's first anomaly
        self.skips = 0              # non-finite steps refused
        self.spikes = 0             # loss-spike episodes latched
        self.rollbacks = 0          # rollbacks performed
        self.log = []               # the records, when no RunLog is
        #                             attached
        self._run_log = None
        self._wd = None
        self._reg = _metrics.registry()

    def attach(self, run_log=None, watchdog=None, registry=None):
        """Wire the run's observability plane (the Trainer calls this once
        its telemetry and watchdog exist): a RunLog for the records, a
        Watchdog for loss-spike alerts, a metrics registry (the
        process-wide one by default) for the counters."""
        self._run_log = run_log
        self._wd = watchdog
        if registry is not None:
            self._reg = registry
        return self

    def _count(self, name):
        self._reg.counter(name, _help(name)).inc()

    def _log(self, record):
        if self._run_log is not None:
            self._run_log.write(record)
        else:
            self.log.append(record)

    # -- per-step host logic (trailing) ------------------------------------
    def observe_step(self, step, loss, applied):
        """Park this step's device scalars and process the pair parked one
        step ago. Returns the mitigation for the processed step: None
        (healthy or skip), "reread" or "rollback"."""
        prev, self._pending = self._pending, (int(step), loss, applied)
        if prev is None:
            return None
        return self._process(*prev)

    def flush_trailing(self):
        """Process the last parked step at the end of a run (its
        mitigation is moot: there is no next step)."""
        prev, self._pending = self._pending, None
        if prev is not None:
            self._process(*prev)

    def _process(self, step, loss, applied):
        return self._classify(step, float(loss.item()),
                              bool(applied.item()))

    def _classify(self, step, loss_v, applied_v):
        """Pure-host triage of one processed step."""
        if not applied_v:
            self.skips += 1
            self._count("trainer.nonfinite_skips")
            kind = "nonfinite"
        elif self._is_spike(loss_v):
            if not self._spike_latched:
                self._spike_latched = True
                self.spikes += 1
                self._count("trainer.loss_spikes")
                if self._wd is not None:
                    self._wd.alert("loss_spike", step, loss=loss_v,
                                   median=self._median())
            kind = "spike"
        else:
            if math.isfinite(loss_v):
                self._window.append(loss_v)
            self.episode = 0
            self.episode_start = None
            if self._spike_latched:
                self._spike_latched = False
                if self._wd is not None:
                    self._wd.resolve("loss_spike")
            return None
        self.episode += 1
        if self.episode == 1:
            self.episode_start = step
        action = (None if self.episode == 1
                  else "reread" if self.episode == 2 else "rollback")
        self._log({"guardian": kind, "step": step, "loss": loss_v,
                   "episode": self.episode, "action": action or "skip"})
        return action

    def _median(self):
        if len(self._window) < self.cfg.min_samples:
            return None
        vals = sorted(self._window)
        n = len(vals)
        mid = n // 2
        return vals[mid] if n % 2 else 0.5 * (vals[mid - 1] + vals[mid])

    def _is_spike(self, loss_v):
        if not math.isfinite(loss_v):
            return True     # a non-finite loss whose update still applied
        med = self._median()
        return (med is not None and med > 0
                and loss_v > self.cfg.spike_factor * med)

    # -- mitigation ladder: rollback ---------------------------------------
    @property
    def rollback_bound(self):
        """Newest checkpoint step safe to roll back to: strictly before the
        episode's first anomalous step."""
        if self.episode_start is None:
            return None
        return int(self.episode_start) - 1

    def begin_rollback(self, at_step, **detail):
        """Charge one rollback against the budget; raises
        :class:`TrainingDiverged` when ``rollback_budget + 1`` rollbacks
        come with no healthy checkpoint between them."""
        self._budget.failure(TrainingDiverged(
            f"loss diverged at step {at_step} and the rollback budget "
            f"({self.cfg.rollback_budget}) is exhausted"))
        fault_point("trainer.rollback")
        self.rollbacks += 1
        self._count("trainer.rollbacks")
        self._log({"guardian": "rollback", "step": int(at_step), **detail})
        # the episode ends; the window stays (the replay walks the same
        # healthy trajectory, and a persistent divergence must re-trip it)
        self.episode = 0
        self.episode_start = None
        self._pending = None

    def note_rollback_done(self, restored_step):
        self._log({"guardian": "rollback_done",
                   "restored_step": int(restored_step)})

    def note_checkpoint(self, step):
        """A checkpoint landed while healthy: the rollback streak resets."""
        if self.healthy():
            self._budget.success()

    def healthy(self):
        """No open anomaly episode (interval saves wait for this)."""
        return self.episode == 0

    # -- resume ------------------------------------------------------------
    def state_dict(self):
        """JSON-serializable detector state for checkpoint meta."""
        return {"skips": self.skips, "spikes": self.spikes,
                "rollbacks": self.rollbacks,
                "window": [float(x) for x in self._window]}

    def load_state(self, sd):
        if not sd:
            return
        self.skips = int(sd.get("skips", 0))
        self.spikes = int(sd.get("spikes", 0))
        self.rollbacks = int(sd.get("rollbacks", 0))
        self._window.clear()
        self._window.extend(float(x) for x in sd.get("window", []))
