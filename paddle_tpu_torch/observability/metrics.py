"""Process-global metrics registry: Counter, Gauge, Histogram (ref:
``paddle_tpu/observability/metrics.py``, standard library only, kept as
the port's own copy).

The serving engine writes its ``serve.*`` family here; a run log's final
record carries the snapshot. Thread-safe.

    from paddle_tpu_torch.observability import metrics

    metrics.counter("serve.tokens").inc(3)
    metrics.gauge("serve.queue_depth").set(2)
    metrics.histogram("serve.ttft_s").observe(0.012)
    snap = metrics.snapshot()      # {"counters": ..., "gauges": ...,
                                   #  "histograms": {name: {p50/p95/...}}}
    metrics.reset_all()            # zero values, keep registrations
"""

import math
import random
import re
import threading
import zlib


def _label_key(labels):
    """Stable flat key for a label set: 'k1=v1,k2=v2' ('' when unlabeled)."""
    if not labels:
        return ""
    return ",".join(f"{k}={labels[k]}" for k in sorted(labels))


# a ',' only separates pairs when what follows looks like a new 'key='
# (label values may themselves contain commas)
_PAIR_SEP = re.compile(r",(?=[A-Za-z_][A-Za-z0-9_]*=)")


def parse_label_key(key):
    """Inverse of _label_key: 'k1=v1,k2=v2' -> {'k1': 'v1', ...}."""
    if not key:
        return {}
    return dict(p.split("=", 1) for p in _PAIR_SEP.split(key))


def _percentile(sorted_vals, q):
    """Linear-interpolated percentile of a pre-sorted list; q in [0, 1]."""
    if not sorted_vals:
        return None
    idx = (len(sorted_vals) - 1) * q
    lo, hi = int(math.floor(idx)), int(math.ceil(idx))
    if lo == hi:
        return sorted_vals[lo]
    frac = idx - lo
    return sorted_vals[lo] * (1.0 - frac) + sorted_vals[hi] * frac


class Counter:
    """Monotonic additive metric; one value per label set."""

    kind = "counter"

    def __init__(self, name, help=""):
        self.name = name
        self.help = help
        self._lock = threading.Lock()
        self._vals = {}

    def inc(self, n=1, **labels):
        k = _label_key(labels)
        with self._lock:
            self._vals[k] = self._vals.get(k, 0) + n

    def value(self, **labels):
        with self._lock:
            return self._vals.get(_label_key(labels), 0)

    def total(self):
        """Sum across every label set."""
        with self._lock:
            return sum(self._vals.values())

    def snapshot(self):
        with self._lock:
            return dict(self._vals)

    def reset(self):
        with self._lock:
            self._vals.clear()


class Gauge:
    """Last-write-wins level metric; one value per label set."""

    kind = "gauge"

    def __init__(self, name, help=""):
        self.name = name
        self.help = help
        self._lock = threading.Lock()
        self._vals = {}

    def set(self, value, **labels):
        with self._lock:
            self._vals[_label_key(labels)] = value

    def value(self, **labels):
        with self._lock:
            return self._vals.get(_label_key(labels))

    def snapshot(self):
        with self._lock:
            return dict(self._vals)

    def reset(self):
        with self._lock:
            self._vals.clear()


class Histogram:
    """Distribution metric: exact count/sum/min/max plus percentiles over
    a bounded UNIFORM reservoir of at most `max_samples` observations
    (Vitter's algorithm R). The reservoir keeps memory flat over
    million-step runs while every observation stays equally likely to be
    retained. Observations that fell out
    of (or never entered) the reservoir are reported as `dropped` in
    stats()/snapshot(), so a consumer can tell sampled percentiles from
    exact ones. The reservoir RNG is seeded from the (name, label) pair:
    identical observation sequences give identical percentiles."""

    kind = "histogram"

    def __init__(self, name, help="", max_samples=2048):
        self.name = name
        self.help = help
        self.max_samples = max_samples
        self._lock = threading.Lock()
        # label key -> dict(count, sum, min, max, reservoir, rng)
        self._series = {}

    def _slot(self, k):
        s = self._series.get(k)
        if s is None:
            seed = zlib.crc32(f"{self.name}|{k}".encode())
            s = self._series[k] = {
                "count": 0, "sum": 0.0, "min": None, "max": None,
                "reservoir": [], "rng": random.Random(seed)}
        return s

    def observe(self, value, **labels):
        v = float(value)
        with self._lock:
            s = self._slot(_label_key(labels))
            s["count"] += 1
            s["sum"] += v
            s["min"] = v if s["min"] is None else min(s["min"], v)
            s["max"] = v if s["max"] is None else max(s["max"], v)
            res = s["reservoir"]
            if len(res) < self.max_samples:
                res.append(v)
            else:
                # algorithm R: observation i (0-based: count-1) replaces a
                # reservoir entry with probability max_samples / count
                j = s["rng"].randrange(s["count"])
                if j < self.max_samples:
                    res[j] = v

    def count(self, **labels):
        with self._lock:
            s = self._series.get(_label_key(labels))
            return s["count"] if s else 0

    def percentile(self, q, **labels):
        """q in [0, 1], over the retained reservoir."""
        with self._lock:
            s = self._series.get(_label_key(labels))
            vals = sorted(s["reservoir"]) if s else []
        return _percentile(vals, q)

    def stats(self, **labels):
        """{"count", "sum", "mean", "min", "max", "dropped", "p50",
        "p95"} or None. `dropped` = observations not retained in the
        reservoir (0 means the percentiles are exact)."""
        with self._lock:
            s = self._series.get(_label_key(labels))
            if s is None or s["count"] == 0:
                return None
            vals = sorted(s["reservoir"])
            out = {"count": s["count"], "sum": s["sum"],
                   "mean": s["sum"] / s["count"],
                   "min": s["min"], "max": s["max"],
                   "dropped": s["count"] - len(vals)}
        out["p50"] = _percentile(vals, 0.50)
        out["p95"] = _percentile(vals, 0.95)
        return out

    def snapshot(self):
        with self._lock:
            keys = list(self._series)
        out = {}
        for k in keys:
            st = self.stats(**parse_label_key(k))
            if st is not None:
                out[k] = st
        return out

    def reset(self):
        with self._lock:
            self._series.clear()


class MetricsRegistry:
    """Name -> metric map with get-or-create accessors. One process-global
    default instance (`registry()`); tests may build private ones."""

    _KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics = {}

    def _get_or_make(self, cls, name, help, **kw):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = cls(name, help=help, **kw)
            elif not isinstance(m, cls):
                raise ValueError(
                    f"metric {name!r} already registered as {m.kind}, "
                    f"requested {cls.kind}")
            return m

    def counter(self, name, help=""):
        return self._get_or_make(Counter, name, help)

    def gauge(self, name, help=""):
        return self._get_or_make(Gauge, name, help)

    def histogram(self, name, help="", max_samples=2048):
        return self._get_or_make(Histogram, name, help,
                                 max_samples=max_samples)

    def get(self, name):
        with self._lock:
            return self._metrics.get(name)

    def names(self):
        with self._lock:
            return sorted(self._metrics)

    def snapshot(self):
        """JSON-ready nested view. Unlabeled metrics flatten to scalars:
        {"counters": {"checkpoint.saves": 2,
                      "retry.attempts": {"op=copy_one": 3}}, ...}"""
        with self._lock:
            items = list(self._metrics.items())
        out = {"counters": {}, "gauges": {}, "histograms": {}}
        section = {"counter": "counters", "gauge": "gauges",
                   "histogram": "histograms"}
        for name, m in items:
            snap = m.snapshot()
            if not snap:
                continue
            if set(snap) == {""}:
                snap = snap[""]
            out[section[m.kind]][name] = snap
        return out

    def reset(self):
        """Zero every metric; registrations (and helper text) survive."""
        with self._lock:
            items = list(self._metrics.values())
        for m in items:
            m.reset()


_DEFAULT = MetricsRegistry()


def registry():
    """The process-global registry every framework counter lives in."""
    return _DEFAULT


def counter(name, help=""):
    return _DEFAULT.counter(name, help)


def gauge(name, help=""):
    return _DEFAULT.gauge(name, help)


def histogram(name, help="", max_samples=2048):
    return _DEFAULT.histogram(name, help, max_samples=max_samples)


def snapshot():
    return _DEFAULT.snapshot()


def reset_all():
    _DEFAULT.reset()
