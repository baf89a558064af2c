"""Trace spans: nestable host-side scopes (ref:
``paddle_tpu/observability/spans.py``).

One ``span(name)`` feeds three sinks at once:

  * the process-wide :class:`~paddle_tpu_torch.profiler.EventRecorder`
    table (:func:`span_summary`, :func:`span_report`),
  * a ``span.<path>`` histogram in the metrics registry, and
  * ``torch.profiler.record_function``, so the scope is a named range in
    a ``torch.profiler`` trace beside the kernels it launched (the
    reference's ``TraceAnnotation``);

and links the finished span into the active trace context through the
flight ring (``trace.note_span``). Nesting joins names with ``/``
(``span("step")`` around ``span("stage")`` records ``step/stage``), on a
stack per thread. A span costs two clock reads and a record_function
scope; it reads nothing from the card.

    from paddle_tpu_torch import observability as obs
    with obs.span("step"):
        ...
    print(obs.span_report())
"""

import contextlib
import threading
import time

import torch

from paddle_tpu_torch.observability import metrics as _metrics
from paddle_tpu_torch.observability import trace as _trace
from paddle_tpu_torch.profiler import EventRecorder

_TLS = threading.local()
_RECORDER = EventRecorder()


def recorder():
    """The process-wide EventRecorder behind :func:`span`."""
    return _RECORDER


@contextlib.contextmanager
def span(name):
    """Time a scope into the span table and the registry, and name it in
    the profiler's trace. The time is recorded when the scope raises
    too."""
    stack = getattr(_TLS, "stack", None)
    if stack is None:
        stack = _TLS.stack = []
    stack.append(str(name))
    full = "/".join(stack)
    t0 = time.perf_counter()
    try:
        with torch.profiler.record_function(str(name)):
            yield
    finally:
        dt = time.perf_counter() - t0
        stack.pop()
        _RECORDER.add(full, dt)
        _metrics.histogram("span." + full).observe(dt)
        _trace.note_span(full, dt)


def annotate_span(name):
    """Decorator twin of :func:`span`."""
    def deco(fn):
        def wrapped(*a, **kw):
            with span(name):
                return fn(*a, **kw)
        return wrapped
    return deco


def span_summary(sort_by="total"):
    """One row per recorded span path (``EventRecorder.summary``)."""
    return _RECORDER.summary(sort_by=sort_by)


def span_report():
    """The sorted text table of every recorded span."""
    return _RECORDER.report()


def reset_spans():
    """Drop the recorded span times (the registry's histograms reset with
    ``metrics.reset_all``)."""
    _RECORDER.reset()
