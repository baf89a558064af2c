r"""Deterministic fault injection for the serving engine's recovery paths
(ref: ``paddle_tpu/testing/chaos.py``, the part the engine needs).

    plan = FaultPlan().fail("fault_point", path=r"^serve\.step$", nth=3)
    with chaos.active(plan):
        engine.drain()
    assert plan.fired() == 1

The engine's hooks are ``fault_point("serve.step")`` (before each decode
step), ``fault_point("serve.prefill")`` (before each prefill chunk) and
``fault_point("serve.prefix_cache")`` (before each prefix-cache match).
Each is a no-op unless a plan is active. All hooks are events of the one
op ``"fault_point"`` whose path is the hook's name, so a rule's ``nth``
counts every hook's events, as in the reference.
"""

import contextlib
import re
import threading


class InjectedFault(OSError):
    """The default injected error."""


class FaultPlan:
    """A deterministic schedule of faults. Rules are matched in insertion
    order against (op, path) events; each op keeps its own 1-based
    occurrence counter. A rule fires when its ``op`` matches, the op's
    occurrence index is >= ``nth``, its ``path`` regex (if any) searches
    the path and its ``times`` budget is not spent; it raises ``exc``
    (default :class:`InjectedFault`)."""

    def __init__(self):
        self._rules = []
        self._counts = {}
        self._lock = threading.Lock()
        self.log = []                  # (op, path, action) of each fault

    def fail(self, op, path=None, nth=1, times=1, exc=None):
        """Add a rule; returns self for chaining."""
        self._rules.append(dict(
            op=op, path=re.compile(path) if path else None, nth=nth,
            remaining=times, exc=exc))
        return self

    def fired(self, op=None):
        """How many faults fired (optionally for one op)."""
        return len([e for e in self.log if op is None or e[0] == op])

    def check(self, op, path=""):
        """Record one (op, path) event; raise per the first matching
        rule."""
        with self._lock:
            n = self._counts[op] = self._counts.get(op, 0) + 1
            rule = None
            for r in self._rules:
                if r["op"] != op or r["remaining"] <= 0 or n < r["nth"]:
                    continue
                if r["path"] is not None and not r["path"].search(str(path)):
                    continue
                r["remaining"] -= 1
                rule = r
                break
        if rule is None:
            return
        exc = rule["exc"] or InjectedFault(
            f"injected fault: {op} #{n} on {path!r}")
        self.log.append((op, path, f"raise:{type(exc).__name__}"))
        raise exc


_ACTIVE = None


@contextlib.contextmanager
def active(plan):
    """Scoped install: ``with chaos.active(plan): ...``."""
    global _ACTIVE
    _ACTIVE = plan
    try:
        yield plan
    finally:
        _ACTIVE = None


def fault_point(name):
    """Named hook in the engine's paths: free when no plan is active;
    under an active plan an event with op ``"fault_point"`` and path
    ``name``."""
    if _ACTIVE is not None:
        _ACTIVE.check("fault_point", name)
