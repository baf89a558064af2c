r"""Deterministic fault injection for the recovery paths (ref:
``paddle_tpu/testing/chaos.py``, the part the engine, the Trainer and
checkpoints need).

    plan = FaultPlan().fail("fault_point", path=r"^serve\.step$", nth=3)
    with chaos.active(plan):
        engine.drain()
    assert plan.fired() == 1

The hooks are ``fault_point(name)``: the engine's ``serve.step`` (before
each decode step or speculative round), ``serve.prefill`` (before each
prefill chunk), ``serve.prefix_cache`` (before each prefix-cache match)
and, with speculation on, ``spec.verify`` (before ``serve.step`` each
round: a fault there runs that round as one plain decode step); the
Trainer's
``trainer.ingest`` (each item a reader yields), ``trainer.step`` (before
each step) and ``trainer.rollback`` (each guardian rollback); the
checkpoint's ``checkpoint.save`` (after a step's file is written, before
it is renamed into place), ``checkpoint.verify`` (before each verified
restore), ``checkpoint.mirror`` (before each push to a remote tree) and
``checkpoint.fetch`` (before a remote step is pulled into staging). Each
is a no-op unless a plan is active. All hooks are events
of the one op ``"fault_point"`` whose path is the hook's name, so a
rule's ``nth`` counts every hook's events, as in the reference.

Besides raising, a rule may poison (:meth:`FaultPlan.poison`):
:meth:`FaultPlan.check` (and a hook) then returns True and the caller
corrupts its own value, as the reference's torn-write rules corrupt a
write instead of failing it. A training drill's loss function calls
``plan.check("loss")`` and makes its loss non-finite when it fires.

:class:`ChaosFS` wraps a filesystem of ``io/fs.py`` and consults a plan
before each of its primitives.
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
        """Add a rule that raises; returns self for chaining."""
        self._rules.append(dict(
            op=op, path=re.compile(path) if path else None, nth=nth,
            remaining=times, exc=exc, poison=False))
        return self

    def poison(self, op, path=None, nth=1, times=1):
        """Add a rule that makes :meth:`check` return True instead of
        raising; returns self for chaining."""
        self.fail(op, path, nth, times)
        self._rules[-1]["poison"] = True
        return self

    def fired(self, op=None):
        """How many faults fired (optionally for one op)."""
        return len([e for e in self.log if op is None or e[0] == op])

    def check(self, op, path=""):
        """Record one (op, path) event; raise per the first matching rule,
        or return True when it poisons."""
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
            return None
        if rule["poison"]:
            self.log.append((op, path, "poison"))
            return True
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
    """Named hook: free when no plan is active; under an active plan an
    event with op ``"fault_point"`` and path ``name``. Returns True when a
    poison rule fired, else None."""
    if _ACTIVE is not None:
        return _ACTIVE.check("fault_point", name)
    return None


class ChaosFS:
    """A filesystem (``io/fs.py``'s six primitives) that consults a plan
    before each: ops ``open`` (a read), ``write`` (a write or append
    open), ``exists``, ``isdir``, ``listdir``, ``makedirs``, ``remove``.
    Register it in place of the real one:
    ``fs.register_filesystem("mem", ChaosFS(fs.MemFS(), plan))``."""

    def __init__(self, inner, plan):
        self.inner = inner
        self.plan = plan

    def open(self, path, mode="rb"):
        self.plan.check("write" if "w" in mode or "a" in mode else "open",
                        path)
        return self.inner.open(path, mode)

    def exists(self, path):
        self.plan.check("exists", path)
        return self.inner.exists(path)

    def isdir(self, path):
        self.plan.check("isdir", path)
        return self.inner.isdir(path)

    def listdir(self, path):
        self.plan.check("listdir", path)
        return self.inner.listdir(path)

    def makedirs(self, path):
        self.plan.check("makedirs", path)
        return self.inner.makedirs(path)

    def remove(self, path):
        self.plan.check("remove", path)
        return self.inner.remove(path)
