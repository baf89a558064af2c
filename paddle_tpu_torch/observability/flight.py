"""Anomaly-triggered flight recorder: a bounded in-memory ring of recent
trace events, dumped as one evidence bundle when a watchdog anomaly fires
(ref: ``paddle_tpu/observability/flight.py``).

The ring keeps the last ``ring`` events of the process (deque appends, no
I/O). ``dump_bundle()`` writes a timestamped directory:

  - ``metrics.json``       the metrics registry's snapshot
  - ``ring.jsonl``         the event ring, oldest first
  - ``runlog_tail.jsonl``  tails of the RunLogs handed in
  - ``config.json``        the ServeConfig or fleet summary handed in
  - ``profile/``           with ``profile_s`` > 0, a ``torch.profiler``
                           capture of that many seconds (a Chrome trace);
                           the section is left out when no trace lands
  - ``MANIFEST.json``      reason, wall time and the section list, written
                           last, so a manifest certifies a whole bundle

A standalone engine's watchdog dumps its own bundle; an engine a fleet
router owns forwards the anomaly through its ``anomaly_sink`` and the
router writes one bundle with every replica's RunLog tail. The dump path
has a ``flight.dump`` fault point and never raises: an anomaly handler
must not take the engine down.

The reference's flags become module settings with the flags' defaults
(``flight_ring`` 256, ``flight_dir`` a ``paddle_tpu_flight`` directory
under the temporary directory, ``flight_profile_s`` 0): change them with
:func:`configure`.
"""

import collections
import itertools
import json
import os
import tempfile
import time

from paddle_tpu_torch.observability import metrics as _metrics
from paddle_tpu_torch.testing.chaos import fault_point

_SETTINGS = {"ring": 256, "directory": None, "profile_s": 0.0}
_SEQ = itertools.count()
_LAST_BUNDLE = None
_RECORDER = None


def configure(ring=None, directory=None, profile_s=None):
    """Set the ring size (0 turns recording off), the bundle directory
    and the profile seconds; None leaves a setting as it is. Returns the
    settings."""
    for key, val in (("ring", ring), ("directory", directory),
                     ("profile_s", profile_s)):
        if val is not None:
            _SETTINGS[key] = val
    return dict(_SETTINGS)


def flight_dir():
    """Where bundles land: the configured directory, else
    ``paddle_tpu_flight`` under the temporary directory."""
    return str(_SETTINGS["directory"]
               or os.path.join(tempfile.gettempdir(), "paddle_tpu_flight"))


class FlightRecorder:
    """Bounded ring of recent events. Appends are single deque operations
    (no lock, no I/O); ``snapshot()`` copies the ring for a dump."""

    def __init__(self, size):
        self.size = int(size)
        self._ring = collections.deque(maxlen=self.size)

    def note_event(self, kind, **fields):
        self._ring.append(dict(event=kind, t=time.perf_counter(),
                               **fields))

    def note(self, rec):
        """Append an already formed trace record (the engine feeds the
        ring the record it logs)."""
        self._ring.append(rec)

    def note_metric_delta(self, name, value, **labels):
        self._ring.append(dict(metric=name, value=value,
                               t=time.perf_counter(), **labels))

    def snapshot(self):
        return list(self._ring)

    def __len__(self):
        return len(self._ring)


def recorder():
    """The process-global ring of the configured size; None when the
    size is 0. A new size builds a fresh ring."""
    global _RECORDER
    size = int(_SETTINGS["ring"])
    if size <= 0:
        return None
    if _RECORDER is None or _RECORDER.size != size:
        _RECORDER = FlightRecorder(size)
    return _RECORDER


def last_bundle():
    """Path of the newest bundle this process dumped, else None."""
    return _LAST_BUNDLE


def _jsonable(obj):
    """JSON view of a config-like object: dicts and lists recurse,
    scalars pass, anything else is its repr."""
    if isinstance(obj, dict):
        return {str(k): _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    return repr(obj)


def _write_json(path, obj):
    with open(path, "w") as fh:
        json.dump(_jsonable(obj), fh, indent=2, sort_keys=True)
        fh.write("\n")


def _write_jsonl(path, records):
    with open(path, "w") as fh:
        for rec in records:
            fh.write(json.dumps(_jsonable(rec)) + "\n")


def _capture_profile(path, seconds):
    """A ``torch.profiler`` capture of ``seconds`` (CPU activity, and
    the card's when there is one) written as a Chrome trace under
    ``path``; True when the trace landed. A diagnostic capture: when the
    profiler is unavailable the bundle goes without it."""
    import torch
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    out = os.path.join(path, "trace.json")
    try:
        os.makedirs(path, exist_ok=True)
        with torch.profiler.profile(activities=acts) as prof:
            time.sleep(seconds)
        prof.export_chrome_trace(out)
    except Exception:
        return False
    return os.path.exists(out)


def dump_bundle(reason, run_logs=(), config=None, extra=None,
                out_dir=None, tail=200, profile_s=None):
    """Write one flight bundle; returns its path, or None when the dump
    failed (counted on ``flight.dumps{status=error}``, never raised).

    ``run_logs``: RunLog paths (or objects with a ``path``) whose tails
    join the bundle; ``config``: the active configuration summary;
    ``extra``: merged into the manifest (the anomaly event, fleet
    state)."""
    global _LAST_BUNDLE
    try:
        fault_point("flight.dump")
        base = out_dir or flight_dir()
        stamp = time.strftime("%Y%m%d-%H%M%S")
        path = os.path.join(
            base, f"flight-{stamp}-p{os.getpid()}-{next(_SEQ)}")
        os.makedirs(path)
        sections = []

        _write_json(os.path.join(path, "metrics.json"),
                    _metrics.snapshot())
        sections.append("metrics.json")

        rec = recorder()
        ring = rec.snapshot() if rec is not None else []
        if rec is not None:
            rec.note_event("flight_dump", reason=reason)
        _write_jsonl(os.path.join(path, "ring.jsonl"), ring)
        sections.append("ring.jsonl")

        from paddle_tpu_torch.observability.runlog import tail_records
        tails = []
        for rl in run_logs:
            p = getattr(rl, "path", rl)
            if not p:
                continue
            try:
                tails.extend(dict(r, _runlog=str(p))
                             for r in tail_records(p, limit=tail))
            except Exception as e:
                tails.append(dict(_runlog=str(p), _error=repr(e)))
        _write_jsonl(os.path.join(path, "runlog_tail.jsonl"), tails)
        sections.append("runlog_tail.jsonl")

        _write_json(os.path.join(path, "config.json"), config or {})
        sections.append("config.json")

        secs = (float(_SETTINGS["profile_s"]) if profile_s is None
                else float(profile_s))
        if secs > 0 and _capture_profile(
                os.path.join(path, "profile"), secs):
            sections.append("profile")

        manifest = dict(reason=reason, wall=time.time(),
                        pid=os.getpid(), ring_events=len(ring),
                        sections=sections)
        if extra:
            manifest.update(_jsonable(extra))
        _write_json(os.path.join(path, "MANIFEST.json"), manifest)
        _metrics.counter("flight.dumps").inc(status="ok")
        _LAST_BUNDLE = path
        return path
    except Exception:
        _metrics.counter("flight.dumps").inc(status="error")
        return None


def read_manifest(bundle_dir):
    """The bundle's manifest, or None when the bundle is incomplete."""
    p = os.path.join(bundle_dir, "MANIFEST.json")
    if not os.path.exists(p):
        return None
    with open(p) as fh:
        return json.load(fh)


def list_bundles(base=None):
    """Complete bundles (manifest present) under the flight directory,
    oldest first."""
    base = base or flight_dir()
    if not os.path.isdir(base):
        return []
    out = [os.path.join(base, d) for d in sorted(os.listdir(base))
           if d.startswith("flight-")]
    return [d for d in out if read_manifest(d) is not None]
