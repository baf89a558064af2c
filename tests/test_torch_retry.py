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
            (RetryPolicy, lambda p: RetryBudget(p, "op")),
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


def _counts(metrics, name, op):
    return metrics.counter(name).value(op=op)


def test_budget_counts_attempts_and_giveups_as_the_reference_does():
    """One budget of 3 attempts, reset once, then run to exhaustion in
    each package: both registries gain 4 ``retry.attempts{op}`` and 1
    ``retry.giveups{op}``."""
    from paddle_tpu.observability import metrics as jmetrics
    from paddle_tpu_torch.observability import metrics as pmetrics
    deltas = []
    for metrics, budget in (
            (pmetrics, RetryBudget(RetryPolicy(max_attempts=3, jitter=0.0,
                                               sleep=lambda s: None),
                                   "unit.budget")),
            (jmetrics, JBudget(JPolicy(max_attempts=3, jitter=0.0,
                                       sleep=lambda s: None),
                               "unit.budget"))):
        before = [_counts(metrics, n, "unit.budget")
                  for n in ("retry.attempts", "retry.giveups")]
        budget.failure(ValueError("x"))
        budget.success()
        budget.failure(ValueError("x"))
        budget.failure(ValueError("x"))
        with pytest.raises(ValueError):
            budget.failure(ValueError("x"))
        deltas.append([_counts(metrics, n, "unit.budget") - b for n, b in
                       zip(("retry.attempts", "retry.giveups"), before)])
    assert deltas[0] == deltas[1] == [4, 1]


def test_callers_pass_the_references_op_labels():
    """The guardian's and the fleet's budgets carry the reference's labels
    (the engine's ``serve.step``: the recovery test below)."""
    import types
    from paddle_tpu_torch.serving.fleet import FleetConfig, FleetRouter
    from paddle_tpu_torch.static.guardian import TrainGuardian
    assert TrainGuardian()._budget.op == "trainer.rollback"
    router = types.SimpleNamespace(cfg=FleetConfig(), _sleep=lambda s: None)
    assert FleetRouter._new_budget(router).op == "fleet.respawn"


def test_step_recovery_counts_serve_step_attempts_in_both_engines():
    """One ``serve.step`` fault recovered by each engine under the same
    fault plan: ``retry.attempts{op=serve.step}`` moves by the same count
    (1) in the two registries, and neither gives up."""
    import jax
    import jax.numpy as jnp  # noqa: F401
    from paddle_tpu.models.gpt import GPTConfig, GPTDecoder
    from paddle_tpu.observability import metrics as jmetrics
    from paddle_tpu.serving import ServeConfig as JServe
    from paddle_tpu.serving import ServingEngine as JEngine
    from paddle_tpu.testing import chaos as jchaos
    from paddle_tpu_torch import bridge
    from paddle_tpu_torch.models.gpt import GPTConfig as PConfig
    from paddle_tpu_torch.models.gpt import GPTDecoder as PDecoder
    from paddle_tpu_torch.observability import metrics as pmetrics
    from paddle_tpu_torch.serving import ServeConfig, ServingEngine
    from paddle_tpu_torch.testing import chaos
    cfg = GPTConfig.tiny()
    cfg.dropout = 0.0
    jm = GPTDecoder(cfg)
    v = jm.init(jax.random.key(0))
    pcfg = PConfig.tiny()
    pcfg.dropout = 0.0
    pm = PDecoder(pcfg, device="cpu", seed=1).eval()
    bridge.load_params(pm, jax.tree_util.tree_map(np.asarray, v["params"]))
    kw = dict(num_slots=2, page_size=8, max_len=24, prefill_len=8,
              step_retries=3)
    prompts = [np.arange(1, 6, dtype=np.int32),
               np.arange(7, 16, dtype=np.int32)]
    deltas = []
    for metrics, run in (
            (jmetrics, lambda: _drive_jax(JEngine(jm, v, JServe(**kw)),
                                          jchaos, prompts)),
            (pmetrics, lambda: _drive_port(
                ServingEngine(pm, ServeConfig(**kw), sleep=lambda s: None),
                chaos, prompts))):
        before = [_counts(metrics, n, "serve.step")
                  for n in ("retry.attempts", "retry.giveups")]
        recoveries = run()
        deltas.append([_counts(metrics, n, "serve.step") - b for n, b in
                       zip(("retry.attempts", "retry.giveups"), before)]
                      + [recoveries])
    assert deltas[0] == deltas[1] == [1, 0, 1]


def _drive_jax(engine, jchaos, prompts):
    for p in prompts:
        engine.submit(p, max_new=6)
    plan = jchaos.FaultPlan(seed=0).fail("fault_point",
                                         path=r"^serve\.step$", nth=4)
    with jchaos.active(plan):
        engine.drain()
    engine.close()
    assert plan.fired() == 1
    return engine.recoveries


def _drive_port(engine, chaos, prompts):
    for p in prompts:
        engine.submit(p, max_new=6)
    plan = chaos.FaultPlan().fail("fault_point", path=r"^serve\.step$",
                                  nth=4)
    with chaos.active(plan):
        engine.drain()
    engine.close()
    assert plan.fired() == 1
    return engine.recoveries
