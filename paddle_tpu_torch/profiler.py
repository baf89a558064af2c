"""Profiling: trace collection and scope annotation (ref:
``paddle_tpu/profiler.py``).

:func:`profiler` wraps a region in ``torch.profiler`` (the CPU's
activity, and the CUDA kernels' when the card is there) and writes a
Chrome trace; :func:`record_event` and :func:`annotate_fn` name a scope
in that trace (``torch.profiler.record_function``, the reference's
``TraceAnnotation``); :class:`EventRecorder` keeps the reference's
sorted host-side table, which ``observability/spans.py`` feeds;
:func:`trace_op_table` sums a trace's CUDA kernels by name, in place of
the reference's XPlane TPU ops.

The reference's ``profiler_dir`` flag becomes the default directory: a
``paddle_tpu_torch_trace`` directory under the temporary directory.
"""

import collections
import contextlib
import glob
import gzip
import json
import os
import tempfile
import time

import torch


def profiler_dir():
    """Where :func:`profiler` writes when no directory is given."""
    return os.path.join(tempfile.gettempdir(), "paddle_tpu_torch_trace")


@contextlib.contextmanager
def profiler(output_dir=None):
    """Profile the region and write ``<output_dir>/trace.json``: CPU
    activity, and CUDA kernels when a card is present. Yields the
    directory."""
    out = output_dir or profiler_dir()
    os.makedirs(out, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield out
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(out, "trace.json"))


def record_event(name):
    """A named scope in the profiler's trace (ref: ``RecordEvent``)."""
    return torch.profiler.record_function(name)


def span(name):
    """The registry-backed span of ``observability/spans.py``: the
    scope's time goes to the span table, a ``span.<path>`` histogram and
    the trace."""
    from paddle_tpu_torch.observability.spans import span as _span
    return _span(name)


def annotate_fn(name):
    """Decorator: every call of the function is a named scope in the
    trace."""
    def deco(fn):
        def wrapped(*a, **kw):
            with torch.profiler.record_function(name):
                return fn(*a, **kw)
        return wrapped
    return deco


class EventRecorder:
    """Host-side timing table (ref: the reference's sorted event tables):
    ``add(name, seconds)`` records one occurrence; ``summary()`` and
    ``report()`` give calls, total, mean, min, max, p50 and p95 per name,
    the largest total first."""

    def __init__(self):
        self._events = collections.defaultdict(list)

    @contextlib.contextmanager
    def record(self, name):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.add(name, time.perf_counter() - t0)

    def add(self, name, seconds):
        self._events[name].append(seconds)

    def reset(self):
        self._events.clear()

    @staticmethod
    def _pctl(sorted_times, q):
        idx = (len(sorted_times) - 1) * q
        lo, hi = int(idx), min(int(idx) + 1, len(sorted_times) - 1)
        frac = idx - lo
        return sorted_times[lo] * (1.0 - frac) + sorted_times[hi] * frac

    def summary(self, sort_by="total"):
        rows = []
        for name, times in list(self._events.items()):
            ts = sorted(times)
            rows.append({
                "name": name, "calls": len(times),
                "total_s": sum(times),
                "avg_ms": 1e3 * sum(times) / len(times),
                "min_ms": 1e3 * ts[0], "max_ms": 1e3 * ts[-1],
                "p50_ms": 1e3 * self._pctl(ts, 0.50),
                "p95_ms": 1e3 * self._pctl(ts, 0.95),
            })
        rows.sort(key=lambda r: -r["total_s"])
        return rows

    def report(self):
        lines = [f"{'Event':<40}{'Calls':>8}{'Total(s)':>12}{'Avg(ms)':>12}"
                 f"{'p50(ms)':>12}{'p95(ms)':>12}"
                 f"{'Min(ms)':>12}{'Max(ms)':>12}"]
        for r in self.summary():
            lines.append(f"{r['name']:<40}{r['calls']:>8}{r['total_s']:>12.4f}"
                         f"{r['avg_ms']:>12.3f}{r['p50_ms']:>12.3f}"
                         f"{r['p95_ms']:>12.3f}{r['min_ms']:>12.3f}"
                         f"{r['max_ms']:>12.3f}")
        return "\n".join(lines)


def _newest_trace(trace_dir):
    files = (glob.glob(os.path.join(trace_dir, "*.json"))
             + glob.glob(os.path.join(trace_dir, "*.json.gz")))
    if not files:
        raise FileNotFoundError(f"no Chrome trace (*.json[.gz]) under "
                                f"{trace_dir}")
    return max(files, key=os.path.getmtime)


def trace_op_table(trace_dir, device_filter="kernel", top=30, steps=1):
    """Per-name durations of a ``torch.profiler`` Chrome trace (the newest
    ``*.json`` or ``*.json.gz`` under ``trace_dir``): the events whose
    category contains ``device_filter`` ("kernel" for the CUDA kernels,
    "gpu_memcpy" for copies, "cpu_op" for host operators; None for every
    complete event). ``steps`` divides the totals. Returns ``[{"name",
    "total_us", "per_step_us", "count"}]``, the largest first, at most
    ``top`` (None for all)."""
    path = _newest_trace(trace_dir)
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        data = json.load(f)
    dur, cnt = collections.Counter(), collections.Counter()
    for e in data.get("traceEvents", []):
        if e.get("ph") != "X" or "name" not in e:
            continue
        if (device_filter is not None
                and device_filter not in str(e.get("cat", ""))):
            continue
        dur[e["name"]] += e.get("dur", 0)
        cnt[e["name"]] += 1
    return [{"name": n, "total_us": d, "per_step_us": d / max(steps, 1),
             "count": cnt[n]} for n, d in dur.most_common(top)]


def print_op_table(trace_dir, **kw):
    """:func:`trace_op_table`, printed."""
    rows = trace_op_table(trace_dir, **kw)
    width = max((len(r["name"]) for r in rows), default=10)
    print(f"{'op':<{width}}  {'total_us':>12}  {'per_step':>10}  {'count':>6}")
    for r in rows:
        print(f"{r['name']:<{width}}  {r['total_us']:>12.0f}  "
              f"{r['per_step_us']:>10.1f}  {r['count']:>6d}")
    return rows
