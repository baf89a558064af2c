"""Fleet-wide tracing: durable trace contexts and the clock-anchored
cross-replica timeline merge (ref: ``paddle_tpu/observability/trace.py``,
standard library only).

The fleet router mints one context (``trace_id`` / ``span_id`` /
``parent_span_id``) per request at ``FleetRouter.submit()``; it rides the
request through every dispatch, failover and handoff hop into
``ServingEngine.adopt()``, which stamps it on the engine's request
instead of minting an engine-scoped id. Every trace event then carries
the same ``trace`` across replicas, with ``replica`` and ``version`` tags
naming who served the hop.

Each RunLog's event times come off the engine's monotonic clock, whose
epoch is per process, so every RunLog opens with an anchor record (one
``time.time()`` and one ``time.perf_counter()`` reading, back to back);
``merge_fleet_trace`` rebases each log's events onto the wall clock with
it and returns one ordered timeline plus a skew report.
"""

import os
import threading
import time
import uuid

#: every event kind the trace plane writes (engine ``_trace_event`` sites
#: and flight-ring ``note_event`` sites)
EVENTS = {
    "adopted": "request adopted by an engine (fleet dispatch, failover "
               "re-route, or drain re-admission)",
    "admitted": "request admitted to a decode slot for its first prefill",
    "anchor": "per-process wall/monotonic clock anchor (skew correction)",
    "anomaly": "watchdog anomaly observed by the flight recorder",
    "first_token": "first generated token left the engine",
    "flight_dump": "flight-recorder bundle dump started",
    "prefill_done": "prompt (+ replayed tokens) fully prefilled",
    "preempted": "running request preempted back to the queue",
    "requeued": "request returned to the queue after a recovery",
    "resumed": "preempted/recovered request re-admitted to a slot",
    "retired": "request reached a terminal status",
    "span": "host-side span completion linked into the active context",
    "submitted": "request accepted (engine-local or fleet submit)",
}


class TraceContext:
    """One hop's identity inside a trace: the durable ``trace_id``, this
    hop's ``span_id`` and its causal parent. ``child()`` derives the next
    hop; ``to_wire()`` / ``from_wire()`` give the JSON-safe dict form the
    router hands an engine."""

    __slots__ = ("trace_id", "span_id", "parent_span_id")

    def __init__(self, trace_id, span_id="root", parent_span_id=None):
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_span_id = parent_span_id

    def child(self, span_id):
        return TraceContext(self.trace_id, span_id,
                            parent_span_id=self.span_id)

    def to_wire(self):
        return {"trace_id": self.trace_id, "span_id": self.span_id,
                "parent_span_id": self.parent_span_id}

    @classmethod
    def from_wire(cls, wire):
        if not wire or not wire.get("trace_id"):
            return None
        return cls(wire["trace_id"], wire.get("span_id", "root"),
                   wire.get("parent_span_id"))

    def __repr__(self):
        return (f"TraceContext({self.trace_id!r}, {self.span_id!r}, "
                f"parent={self.parent_span_id!r})")


def mint_run():
    """Short run id prefixing every trace id one router or standalone
    engine mints."""
    return uuid.uuid4().hex[:8]


_TLS = threading.local()     # this thread's stack of active contexts


def current():
    """The innermost active TraceContext on this thread, else None."""
    stack = getattr(_TLS, "stack", None)
    return stack[-1] if stack else None


class activate:
    """``with trace.activate(ctx):`` installs ``ctx`` as the thread's
    active context for the block; nests."""

    def __init__(self, ctx):
        self._ctx = ctx

    def __enter__(self):
        stack = getattr(_TLS, "stack", None)
        if stack is None:
            stack = _TLS.stack = []
        stack.append(self._ctx)
        return self._ctx

    def __exit__(self, *exc):
        _TLS.stack.pop()
        return False


def note_span(name, dt):
    """Link a completed host-side span into the active context through
    the flight ring (a deque append); nothing when recording is off."""
    from paddle_tpu_torch.observability import flight
    rec = flight.recorder()
    if rec is None:
        return
    ctx = current()
    rec.note_event("span", name=name, dt=dt,
                   trace=ctx.trace_id if ctx else None,
                   span=ctx.span_id if ctx else None)


def anchor_record(**tags):
    """One wall/monotonic clock pair taken back to back, tagged with the
    writing process."""
    return dict(anchor=dict(wall=time.time(), mono=time.perf_counter()),
                pid=os.getpid(), **tags)


def write_anchor(run_log, **tags):
    """Write an anchor record to ``run_log`` (None: no log) and mirror it
    into the flight ring when recording."""
    rec = anchor_record(**tags)
    if run_log is not None:
        run_log.write(rec)
    from paddle_tpu_torch.observability import flight
    fl = flight.recorder()
    if fl is not None:
        fl.note_event("anchor", wall=rec["anchor"]["wall"],
                      mono=rec["anchor"]["mono"], pid=rec["pid"])
    return rec


def _anchor_offset(records):
    """wall - mono from the log's first anchor record, else None."""
    for rec in records:
        a = rec.get("anchor")
        if isinstance(a, dict) and "wall" in a and "mono" in a:
            return float(a["wall"]) - float(a["mono"])
    return None


def merge_fleet_trace(record_lists):
    """Merge per-replica RunLog record lists (``{source: records}``) into
    one timeline. Each log's trace events (records with ``event`` and
    ``t``) are rebased onto the wall clock by the log's anchor offset; a
    log without an anchor keeps raw times and says so in the skew
    report. Returns ``{"events": [...], "skew": {...}}``: each event
    gains ``source`` and ``wall_t``, sorted by (wall_t, source); ``skew``
    holds each source's offset and its skew from the earliest-anchored
    source."""
    offsets = {src: _anchor_offset(recs)
               for src, recs in record_lists.items()}
    anchored = {s: o for s, o in offsets.items() if o is not None}
    base = min(anchored.values()) if anchored else 0.0
    events = []
    for src, recs in record_lists.items():
        off = offsets[src]
        for rec in recs:
            if "event" not in rec or "t" not in rec:
                continue
            ev = dict(rec)
            ev["source"] = src
            ev["wall_t"] = (float(rec["t"]) + off if off is not None
                            else float(rec["t"]))
            events.append(ev)
    events.sort(key=lambda e: (e["wall_t"], e["source"]))
    skew = {src: dict(offset=off,
                      skew_s=(off - base if off is not None else None),
                      anchored=off is not None)
            for src, off in offsets.items()}
    return {"events": events, "skew": skew}


def group_by_trace(events):
    """``{trace_id: [events...]}`` in merged order; events with no trace
    stamp group under None."""
    out = {}
    for ev in events:
        out.setdefault(ev.get("trace"), []).append(ev)
    return out
