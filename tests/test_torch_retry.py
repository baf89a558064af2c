"""The port's retry policy against the reference's (``core/retry.py``), on
the CPU: a policy built with only some knobs takes the others from the
retry settings, as the reference's takes them from its ``retry_*``
flags, so its sleeps are capped, jittered and bounded by the deadline.
Both draw their jitter from the global ``random`` module unless given an
``rng``, so seeding it identically gives the same delays (within 1e-12),
and an injected clock shows the same give-up point."""

import random

import numpy as np
import pytest

from paddle_tpu.core.flags import get_flag
from paddle_tpu.core.retry import RetryBudget as JBudget
from paddle_tpu.core.retry import RetryPolicy as JPolicy
from paddle_tpu_torch.core import retry as pretry
from paddle_tpu_torch.core.retry import RetryBudget, RetryPolicy

#: the port's setting beside the reference's flag
KNOBS = (("max_attempts", "retry_max_attempts", "max_attempts"),
         ("backoff_s", "retry_backoff_base_s", "backoff_base_s"),
         ("backoff_max_s", "retry_backoff_max_s", "backoff_max_s"),
         ("multiplier", "retry_backoff_multiplier", "backoff_multiplier"),
         ("jitter", "retry_jitter", "jitter"),
         ("deadline_s", "retry_deadline_s", "deadline_s"))


@pytest.fixture
def settings():
    """The port's retry settings, restored after the test."""
    saved = pretry.configure()
    yield
    pretry.configure(**saved)


@pytest.mark.parametrize("seed", [0, 7, 12345])
def test_delays_equal_the_references_from_a_seeded_random(seed):
    """``RetryPolicy(max_attempts=12)``, as the engine, fleet and guardian
    budgets build it: the n-th delay for n = 1..11 is the reference's."""
    random.seed(seed)
    port = RetryPolicy(max_attempts=12)
    got = [port.delay_s(n) for n in range(1, 12)]
    random.seed(seed)
    ref = JPolicy(max_attempts=12)
    want = [ref.backoff_s(n) for n in range(1, 12)]
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    assert max(got) <= 2.0 * 1.25          # capped, then jittered
    assert len(set(got)) == len(got)       # every sleep jittered


def test_delays_equal_the_references_from_an_injected_rng():
    port = RetryPolicy(max_attempts=12, rng=random.Random(3))
    ref = JPolicy(max_attempts=12, rng=random.Random(3))
    np.testing.assert_allclose([port.delay_s(n) for n in range(1, 12)],
                               [ref.backoff_s(n) for n in range(1, 12)],
                               rtol=0, atol=1e-12)


@pytest.mark.parametrize("knob", KNOBS, ids=[k[0] for k in KNOBS])
def test_unset_knobs_are_the_flags_defaults(knob):
    port_name, flag, ref_name = knob
    port, ref = RetryPolicy(), JPolicy()
    assert getattr(port, port_name) == getattr(ref, ref_name) == \
        get_flag(flag)
    assert getattr(pretry.default_policy(), port_name) == get_flag(flag)


def test_configure_flows_into_policies_built_after(settings):
    before = RetryPolicy(max_attempts=5)
    pretry.configure(jitter=0.1, backoff_max_s=0.5)
    after = RetryPolicy(max_attempts=5)
    assert (after.jitter, after.backoff_max_s) == (0.1, 0.5)
    assert (before.jitter, before.backoff_max_s) == (0.25, 2.0)
    assert RetryPolicy(max_attempts=5, jitter=0.0).jitter == 0.0
    assert pretry.default_policy().jitter == 0.1


class _Clock:
    """A clock that every sleep advances."""

    def __init__(self):
        self.now = 0.0

    def __call__(self):
        return self.now

    def sleep(self, s):
        self.now += s


def test_call_gives_up_at_the_deadline_as_the_reference_does():
    def run(make):
        clock = _Clock()
        calls = []

        def flaky():
            calls.append(clock())
            raise OSError("transient")
        pol = make(clock)
        with pytest.raises(OSError):
            pol.call(flaky)
        return calls
    port = run(lambda c: RetryPolicy(max_attempts=50, deadline_s=1.0,
                                     jitter=0.0, sleep=c.sleep, clock=c))
    ref = run(lambda c: JPolicy(max_attempts=50, deadline_s=1.0, jitter=0.0,
                                sleep=c.sleep, clock=c))
    np.testing.assert_allclose(port, ref, rtol=0, atol=1e-12)
    assert len(port) < 50 and port[-1] <= 1.0


def test_budget_ignores_the_deadline_as_the_reference_does():
    """A budget counts attempts only: its sleeps run on past the policy's
    deadline, in both packages."""
    for make, budget_of in (
            (RetryPolicy, lambda p: RetryBudget(p)),
            (lambda **kw: JPolicy(
                backoff_base_s=kw.pop("backoff_s"), **kw),
             lambda p: JBudget(p, "op"))):
        slept = []
        budget = budget_of(make(max_attempts=6, backoff_s=1.0, jitter=0.0,
                                deadline_s=0.5, sleep=slept.append))
        for n in range(1, 6):
            assert budget.failure(ValueError("x")) == n
        with pytest.raises(ValueError):
            budget.failure(ValueError("x"))
        assert slept == [1.0, 2.0, 2.0, 2.0, 2.0]
