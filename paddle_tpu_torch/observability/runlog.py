"""RunLog: an append-only JSONL sink for per-step records (ref:
``paddle_tpu/observability/runlog.py``, standard library only, kept as
the port's own copy).

One JSON object per line, flushed as written (a killed run keeps every
record up to its last step), with record-count rotation.

    log = RunLog("/runs/exp1/run.jsonl", rotate_records=100_000)
    log.write({"step": 10, "wall_s": 0.012})
    log.close()

    for rec in read_records("/runs/exp1/run.jsonl"):  # rotation-aware
        ...
"""

import glob
import json
import os
import threading


class RunLog:
    """Thread-safe JSONL writer with optional record-count rotation.

    rotate_records=N (0 = never rotate): after N records the live file is
    rolled to ``<path>.1`` (existing rolls shift up, the oldest beyond
    ``keep_rotated`` is dropped) and a fresh file starts. ``read_records``
    reassembles the full stream oldest-first.
    """

    def __init__(self, path, rotate_records=0, keep_rotated=3):
        self.path = str(path)
        self.rotate_records = int(rotate_records or 0)
        self.keep_rotated = max(1, int(keep_rotated))
        self._lock = threading.Lock()
        self._fh = None
        self._count = 0
        d = os.path.dirname(os.path.abspath(self.path))
        os.makedirs(d, exist_ok=True)

    def _open(self):
        if self._fh is None:
            self._fh = open(self.path, "a")
        return self._fh

    def _rotate(self):
        if self._fh is not None:
            self._fh.close()
            self._fh = None
        oldest = f"{self.path}.{self.keep_rotated}"
        if os.path.exists(oldest):
            os.remove(oldest)
        for i in range(self.keep_rotated - 1, 0, -1):
            src = f"{self.path}.{i}"
            if os.path.exists(src):
                os.replace(src, f"{self.path}.{i + 1}")
        if os.path.exists(self.path):
            os.replace(self.path, f"{self.path}.1")
        self._count = 0

    def write(self, record):
        """Append one record (a JSON-serializable dict) and flush."""
        line = json.dumps(record)
        with self._lock:
            if self.rotate_records and self._count >= self.rotate_records:
                self._rotate()
            fh = self._open()
            fh.write(line + "\n")
            fh.flush()
            self._count += 1

    def close(self):
        with self._lock:
            if self._fh is not None:
                self._fh.close()
                self._fh = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def _rotated_siblings(path):
    """``path.N`` rotation siblings, oldest (highest N) first. Only
    fully numeric suffixes qualify: the ``.[0-9]*`` glob alone also
    matches e.g. ``run.jsonl.2bak``, whose suffix would crash the sort
    key and take every report down with it."""
    sibs = []
    for p in glob.glob(glob.escape(str(path)) + ".[0-9]*"):
        suffix = p.rsplit(".", 1)[1]
        if suffix.isdigit():
            sibs.append((int(suffix), p))
    return [p for _, p in sorted(sibs, reverse=True)]


def read_records(path):
    """Every record of a (possibly rotated) RunLog, oldest first.

    Tolerates a torn final line (a run killed mid-write leaves at most
    one truncated record; it is skipped, everything durable is kept)."""
    files = _rotated_siblings(path)
    if os.path.exists(path):
        files.append(str(path))
    out = []
    for f in files:
        with open(f) as fh:
            for line in fh:
                line = line.strip()
                if not line:
                    continue
                try:
                    out.append(json.loads(line))
                except ValueError:
                    continue    # torn tail of a killed writer
    return out


def tail_records(path, limit=200):
    """The last ``limit`` records of a (possibly rotated) RunLog, in
    order. Reads the full stream (rotation bounds its size) and
    slices."""
    recs = read_records(path)
    return recs[-int(limit):] if limit else recs
