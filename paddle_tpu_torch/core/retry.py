"""Consecutive-failure retry budget for loop-shaped consumers (ref:
``paddle_tpu/core/retry.py``): the serving engine's step recovery counts
each failed step, sleeps a backoff, and re-raises once the budget is
spent. Only the policy's attempt count, its backoff and an injectable
sleep are ported; the metrics and the call/decorator forms are not.
"""

import time


class RetryPolicy:
    """``max_attempts`` failures in a row are allowed before giving up;
    the n-th failure sleeps ``backoff_s * 2 ** (n - 1)``. ``sleep`` is
    injectable for tests."""

    def __init__(self, max_attempts=4, backoff_s=0.05, sleep=None):
        self.max_attempts = max(1, int(max_attempts))
        self.backoff_s = float(backoff_s)
        self._sleep = sleep or time.sleep

    def delay_s(self, attempt):
        """Sleep before retry number ``attempt`` (1-based failure
        count)."""
        return max(0.0, self.backoff_s * 2.0 ** max(0, attempt - 1))


class RetryBudget:
    """Consecutive-failure budget over a :class:`RetryPolicy`:
    ``failure(exc)`` counts a failure, sleeps the policy's backoff and
    returns the streak length, or re-raises ``exc`` once the policy's
    attempts are spent; ``success()`` resets the streak."""

    def __init__(self, policy):
        self.policy = policy
        self.failures = 0

    def success(self):
        self.failures = 0

    def failure(self, exc):
        self.failures += 1
        if self.failures >= self.policy.max_attempts:
            raise exc
        self.policy._sleep(self.policy.delay_s(self.failures))
        return self.failures
