"""Worker liveness: heartbeat monitors and bounded-wait barriers (ref:
``paddle_tpu/parallel/heartbeat.py``, the in-process and shared-directory
parts).

``HeartBeatMonitor`` tracks pings in process (the fleet router pings
each replica every healthy round and scans for stalls); ``FileHeartbeat``
pings through file mtimes in a shared directory; ``barrier_with_timeout``
is a file barrier with a deadline. The coordination-service transports
of the reference (``KVHeartbeat``, ``KVMonitor``, ``kv_barrier``) ride
``jax.distributed`` and are not ported.

The reference's flags become defaults: ``dist_heartbeat_timeout_s``
300.0 and ``dist_heartbeat_interval_s`` 10.0.
"""

import os
import threading
import time

from paddle_tpu_torch.observability import metrics as _metrics

UNINITED = "UNINITED"
RUNNING = "RUNNING"
COMPLETED = "COMPLETED"
STALLED = "STALLED"

TIMEOUT_S = 300.0
INTERVAL_S = 10.0


class HeartBeatMonitor:
    """Worker liveness from pings: ``check()`` flips a RUNNING worker
    silent past ``timeout_s`` to STALLED and calls ``on_stall(worker,
    age)``. ``clock`` is injectable."""

    def __init__(self, num_workers, timeout_s=None, interval_s=None,
                 on_stall=None, clock=time.monotonic):
        self.num_workers = num_workers
        self.timeout_s = timeout_s if timeout_s is not None else TIMEOUT_S
        self.interval_s = (interval_s if interval_s is not None
                           else INTERVAL_S)
        self.on_stall = on_stall
        self._clock = clock
        self._lock = threading.Lock()
        self._last = {}                  # worker -> last ping time
        self._state = {i: UNINITED for i in range(num_workers)}
        self._thread = None
        self._stop = threading.Event()

    def update(self, worker, state=RUNNING):
        """Record a ping. A COMPLETED worker stays so unless the ping
        says COMPLETED again."""
        with self._lock:
            self._last[worker] = self._clock()
            if self._state.get(worker) != COMPLETED or state == COMPLETED:
                self._state[worker] = state

    def complete(self, worker):
        self.update(worker, COMPLETED)

    def add_worker(self, worker=None):
        """Grow the monitored set by one; returns the new worker's
        index."""
        with self._lock:
            if worker is None:
                worker = self.num_workers
            self.num_workers = max(self.num_workers, worker + 1)
            self._state.setdefault(worker, UNINITED)
            return worker

    def check(self):
        """One scan: ``{worker: (state, age_s)}``. The stall callback runs
        after the lock is released."""
        now = self._clock()
        out = {}
        stalls = []
        with self._lock:
            for w in range(self.num_workers):
                age = now - self._last.get(w, now)
                st = self._state.get(w, UNINITED)
                if st == RUNNING and age > self.timeout_s:
                    st = self._state[w] = STALLED
                    stalls.append((w, age))
                out[w] = (st, age)
        for w, age in stalls:
            _metrics.counter("heartbeat.missed").inc(worker=w)
            if self.on_stall is not None:
                self.on_stall(w, age)
        return out

    def start(self):
        """Scan every ``interval_s`` from a daemon thread."""
        if self._thread is not None:
            return
        self._stop.clear()

        def loop():
            while not self._stop.wait(self.interval_s):
                self.check()

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="heartbeat-monitor")
        self._thread.start()

    def stop(self):
        if self._thread is not None:
            self._stop.set()
            self._thread.join(timeout=5)
            self._thread = None

    def all_completed(self):
        with self._lock:
            return all(s == COMPLETED for s in self._state.values())


class FileHeartbeat:
    """Heartbeat over a shared directory: worker ``i`` touches
    ``<dir>/worker_<i>.hb``; any process can :meth:`scan` the mtimes."""

    def __init__(self, directory, worker):
        self.dir = directory
        self.worker = worker
        os.makedirs(directory, exist_ok=True)
        self.path = os.path.join(directory, f"worker_{worker}.hb")

    def ping(self):
        with open(self.path, "a"):
            os.utime(self.path, None)

    def complete(self):
        with open(self.path + ".done", "w") as f:
            f.write("done")

    @staticmethod
    def scan(directory, num_workers, timeout_s):
        """``{worker: (state, age_s)}`` from the file mtimes."""
        now = time.time()
        out = {}
        for w in range(num_workers):
            p = os.path.join(directory, f"worker_{w}.hb")
            if os.path.exists(p + ".done"):
                out[w] = (COMPLETED, 0.0)
            elif not os.path.exists(p):
                out[w] = (UNINITED, 0.0)
            else:
                age = now - os.path.getmtime(p)
                out[w] = (STALLED if age > timeout_s else RUNNING, age)
        return out


def barrier_with_timeout(directory, worker, num_workers, timeout_s=300.0,
                         tag="barrier", poll_s=0.05):
    """File-based N-way barrier with a deadline; raises TimeoutError
    naming the missing workers. One use per (directory, tag): the marker
    files stay."""
    os.makedirs(directory, exist_ok=True)
    mine = os.path.join(directory, f"{tag}.{worker}")
    with open(mine, "w") as f:
        f.write(str(worker))
    deadline = time.time() + timeout_s
    t0 = time.monotonic()
    try:
        while True:
            present = {i for i in range(num_workers) if os.path.exists(
                os.path.join(directory, f"{tag}.{i}"))}
            if len(present) == num_workers:
                return
            if time.time() > deadline:
                missing = sorted(set(range(num_workers)) - present)
                raise TimeoutError(
                    f"barrier '{tag}' timed out after {timeout_s}s; "
                    f"missing workers {missing}")
            time.sleep(poll_s)
    finally:
        _metrics.counter("heartbeat.barrier_wait_s").inc(
            time.monotonic() - t0, barrier=tag)
