"""Retry with backoff (ref: ``paddle_tpu/core/retry.py``).

:meth:`RetryPolicy.call` retries a callable's transient failures
(``OSError``, ``ConnectionError``, ``TimeoutError``; never a missing
file) with exponential backoff, jitter and an overall deadline, and
counts ``retry.attempts{op}`` and ``retry.giveups{op}``: the remote
primitives of ``io/fs.py`` and the checkpoint mirror go through it.
:class:`RetryBudget` is the loop-shaped form: the serving engine's step
recovery, the fleet's respawns and the guardian's rollbacks count each
failure, sleep a backoff and re-raise once the budget is spent.

The reference's ``retry_*`` flags become module settings with the flags'
defaults (4 attempts, 0.05 s doubling to at most 2 s, jitter 0.25, a
60 s deadline): a :class:`RetryPolicy` reads every knob left unset from
them when it is built, as the reference reads its flags, and
:func:`configure` changes them.
"""

import random as _random
import time

from paddle_tpu_torch.observability import metrics as _metrics

_SETTINGS = {"max_attempts": 4, "backoff_s": 0.05, "backoff_max_s": 2.0,
             "multiplier": 2.0, "jitter": 0.25, "deadline_s": 60.0}


def configure(**settings):
    """Set retry defaults (the keys of :data:`_SETTINGS`); None leaves a
    setting as it is. Returns the settings."""
    for key, val in settings.items():
        if key not in _SETTINGS:
            raise KeyError(f"unknown retry setting {key!r}")
        if val is not None:
            _SETTINGS[key] = val
    return dict(_SETTINGS)


def default_retryable(exc):
    """Transient-looking I/O failures retry; a missing file, a directory
    where a file was expected or a refused permission never does."""
    if isinstance(exc, (FileNotFoundError, NotADirectoryError,
                        IsADirectoryError, PermissionError)):
        return False
    return isinstance(exc, (OSError, ConnectionError, TimeoutError))


class RetryPolicy:
    """``max_attempts`` tries; the n-th failure sleeps ``backoff_s *
    multiplier ** (n - 1)``, at most ``backoff_max_s``, scaled by a
    uniform factor in ``[1 - jitter, 1 + jitter]``; a call gives up
    rather than start a sleep that would end past ``deadline_s`` (0:
    none). A knob left None takes its setting (:data:`_SETTINGS`) when
    the policy is built (ref: ``core/retry.py:56-70``). ``retryable``
    (default :func:`default_retryable`) says which exceptions are
    retried. ``sleep``, ``rng`` (a ``random.Random``; the global
    ``random`` module by default, as in the reference) and ``clock``
    are injectable for tests."""

    def __init__(self, max_attempts=None, backoff_s=None, sleep=None,
                 backoff_max_s=None, multiplier=None, jitter=None,
                 deadline_s=None, retryable=None, rng=None, clock=None):
        def knob(val, key):
            return _SETTINGS[key] if val is None else val
        self.max_attempts = max(1, int(knob(max_attempts, "max_attempts")))
        self.backoff_s = float(knob(backoff_s, "backoff_s"))
        self.backoff_max_s = float(knob(backoff_max_s, "backoff_max_s"))
        self.multiplier = float(knob(multiplier, "multiplier"))
        self.jitter = float(knob(jitter, "jitter"))
        self.deadline_s = float(knob(deadline_s, "deadline_s"))
        self.retryable = retryable or default_retryable
        self._sleep = sleep or time.sleep
        self._rng = rng or _random
        self._clock = clock or time.monotonic

    def delay_s(self, attempt):
        """Sleep before retry number ``attempt`` (1-based failure
        count)."""
        d = min(self.backoff_max_s,
                self.backoff_s * self.multiplier ** max(0, attempt - 1))
        if self.jitter:
            d *= 1.0 + self.jitter * (2.0 * self._rng.random() - 1.0)
        return max(0.0, d)

    def call(self, fn, *args, **kwargs):
        """``fn(*args, **kwargs)``, retrying retryable failures; the last
        exception is re-raised as itself. Counts ``retry.attempts`` for
        each retryable failure and ``retry.giveups`` when the attempts or
        the deadline run out, labelled with ``fn``'s name."""
        start = self._clock()
        failures = 0
        op = getattr(fn, "__name__", None) or type(fn).__name__
        while True:
            try:
                return fn(*args, **kwargs)
            except Exception as e:
                failures += 1
                if not self.retryable(e):
                    raise
                _metrics.counter("retry.attempts").inc(op=op)
                if failures >= self.max_attempts:
                    _metrics.counter("retry.giveups").inc(op=op)
                    raise
                delay = self.delay_s(failures)
                if (self.deadline_s > 0
                        and self._clock() - start + delay
                        > self.deadline_s):
                    _metrics.counter("retry.giveups").inc(op=op)
                    raise
                self._sleep(delay)


def default_policy():
    """A policy from the current settings (read at each call)."""
    return RetryPolicy()


class RetryBudget:
    """Consecutive-failure budget over a :class:`RetryPolicy`:
    ``failure(exc)`` counts a failure, sleeps the policy's backoff and
    returns the streak length, or re-raises ``exc`` once the policy's
    attempts are spent; ``success()`` resets the streak. Each failure
    counts ``retry.attempts{op}`` and a give-up ``retry.giveups{op}``, as
    :meth:`RetryPolicy.call` does."""

    def __init__(self, policy, op):
        self.policy = policy
        self.op = op
        self.failures = 0

    def success(self):
        self.failures = 0

    def failure(self, exc):
        self.failures += 1
        _metrics.counter("retry.attempts").inc(op=self.op)
        if self.failures >= self.policy.max_attempts:
            _metrics.counter("retry.giveups").inc(op=self.op)
            raise exc
        self.policy._sleep(self.policy.delay_s(self.failures))
        return self.failures
