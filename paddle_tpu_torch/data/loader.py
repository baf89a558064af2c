"""Data loading with device prefetch (ref: ``paddle_tpu/data/loader.py``).

:class:`DataLoader` batches a sample generator (``from_generator``, with
the reference's seeded shuffle buffer, so the port yields the same
batches in the same order) or takes a batch generator
(``from_batch_generator``), and a background thread keeps ``prefetch``
batches placed on the device ahead of the consumer.

Placement (:class:`Stager`, which every loader holds and the serving
engine holds on its own): on the CPU a batch becomes plain tensors. On
the card each array is copied into pinned host memory and then to the
device with ``non_blocking=True`` on a copy stream the stager owns, and
an event is recorded behind the copies; ``place`` returns a
:class:`Staged` batch at once. Before first use the consumer calls
:meth:`Stager.ready` (``__iter__`` does so for it), which makes the
consumer's stream wait on that event and marks each tensor as used on
that stream (``Tensor.record_stream``), so the caching allocator does
not hand the block out again while a later use is still queued. The
serving engine stages prompts this way at ``submit``, from whatever
thread submits.

The reference's ``reader_queue_size`` flag (the default prefetch depth,
2) is a module setting read from ``PT_FLAGS_reader_queue_size``; change
it with :func:`configure`. A mesh (sharded batches) is not ported.
"""

import queue
import threading

import numpy as np
import torch

from paddle_tpu_torch.core.device import resolve_device
from paddle_tpu_torch.core.enforce import enforce
from paddle_tpu_torch.core.settings import env_default

_SETTINGS = {"reader_queue_size": env_default("reader_queue_size", 2)}

#: the name of every loader's prefetch thread
THREAD_NAME = "paddle_tpu_torch.DataLoader"


def configure(reader_queue_size=None):
    """Set the default prefetch depth (None leaves it as it is); returns
    the settings."""
    if reader_queue_size is not None:
        _SETTINGS["reader_queue_size"] = int(reader_queue_size)
    return dict(_SETTINGS)


def _tree_map(fn, batch):
    if isinstance(batch, (tuple, list)):
        return type(batch)(_tree_map(fn, b) for b in batch)
    if isinstance(batch, dict):
        return {k: _tree_map(fn, v) for k, v in batch.items()}
    return fn(batch)


def _leaves(batch):
    out = []
    _tree_map(out.append, batch)
    return out


class Staged:
    """A batch whose copies to the card are queued on a loader's copy
    stream; :meth:`wait` orders a stream after them and returns the
    batch."""

    __slots__ = ("batch", "event", "_host")

    def __init__(self, batch, event, host):
        self.batch = batch
        self.event = event
        self._host = host             # the pinned sources of the copies

    def wait(self, stream=None):
        """Make ``stream`` (default: the current stream of the batch's
        device) wait for the copies and record the batch's use on it;
        returns the batch. Safe to call again, from any stream."""
        leaves = _leaves(self.batch)
        stream = stream or torch.cuda.current_stream(leaves[0].device)
        stream.wait_event(self.event)
        for t in leaves:
            t.record_stream(stream)
        return self.batch


class Stager:
    """Host-to-device placement of numpy batches (tuples, lists or dicts
    of arrays) onto ``device``, safe to call from any thread."""

    def __init__(self, device):
        self._device = device
        self._stream = None
        self._stream_lock = threading.Lock()

    def _copy_stream(self):
        with self._stream_lock:
            if self._stream is None:
                self._stream = torch.cuda.Stream(self._device)
            return self._stream

    def place(self, batch):
        """Stage one host batch onto the device. On the CPU: the batch as
        tensors (a copy). On the card: a :class:`Staged` batch whose
        copies are queued on the stager's copy stream; pass it to
        :meth:`ready` before use."""
        if self._device.type == "cpu":
            return _tree_map(
                lambda a: torch.from_numpy(np.array(a, copy=True)), batch)
        pinned = _tree_map(  # pin_memory copies
            lambda a: torch.from_numpy(np.ascontiguousarray(a)).pin_memory(),
            batch)
        stream = self._copy_stream()
        with torch.cuda.stream(stream):
            placed = _tree_map(
                lambda t: t.to(self._device, non_blocking=True), pinned)
            event = torch.cuda.Event()
            event.record(stream)
        return Staged(placed, event, pinned)

    @staticmethod
    def ready(placed, stream=None):
        """A placed batch ready for use on ``stream`` (default: the
        current stream): a :class:`Staged` one waited for, anything else
        as it is."""
        return placed.wait(stream) if isinstance(placed, Staged) else placed


class DataLoader:
    """Iterable loader over a batch reader with device prefetch;
    ``from_generator`` builds one from a per-sample generator of numpy
    samples (tuples or dicts), as the reference does. ``device`` defaults
    to the card and raises without one unless the CPU is asked for;
    ``mesh`` must be None (``sharding_axis`` is kept for the reference's
    signature)."""

    def __init__(self, batch_reader, prefetch=None, mesh=None,
                 sharding_axis="dp", device="cuda"):
        enforce(mesh is None, "DataLoader(mesh=...): sharded batches are "
                "not ported (the port runs on one card)")
        self._batch_reader = batch_reader
        self._prefetch = prefetch or _SETTINGS["reader_queue_size"]
        self._stager = Stager(resolve_device(device))

    @staticmethod
    def from_generator(generator=None, batch_size=None, shuffle=False,
                       shuffle_buffer=1024, seed=0, mesh=None, prefetch=None,
                       drop_last=True, device="cuda"):
        """Batches of ``batch_size`` samples of ``generator()``; with
        ``shuffle`` through a buffer of ``shuffle_buffer`` samples drawn
        by ``np.random.RandomState(seed)`` (the reference's order)."""
        def batch_reader():
            rng = np.random.RandomState(seed)
            buf = []
            pool = []
            for sample in generator():
                if shuffle:
                    pool.append(sample)
                    if len(pool) >= shuffle_buffer:
                        idx = rng.randint(len(pool))
                        buf.append(pool.pop(idx))
                else:
                    buf.append(sample)
                if len(buf) == batch_size:
                    yield _collate(buf)
                    buf = []
            while pool:
                idx = rng.randint(len(pool)) if shuffle else 0
                buf.append(pool.pop(idx))
                if len(buf) == batch_size:
                    yield _collate(buf)
                    buf = []
            if buf and not drop_last:
                yield _collate(buf)

        return DataLoader(batch_reader, mesh=mesh, prefetch=prefetch,
                          device=device)

    @staticmethod
    def from_batch_generator(generator, mesh=None, prefetch=None,
                             device="cuda"):
        """A loader over a generator function of whole batches."""
        return DataLoader(generator, mesh=mesh, prefetch=prefetch,
                          device=device)

    def place(self, batch):
        """Stage one host batch onto the loader's device
        (:meth:`Stager.place`)."""
        return self._stager.place(batch)

    ready = staticmethod(Stager.ready)

    def __iter__(self):
        q = queue.Queue(maxsize=self._prefetch)
        stop = object()
        cancelled = threading.Event()
        err = []

        def put(item):
            # a bounded put that notices the consumer's cancellation, so
            # an early `break` cannot leave this thread blocked holding
            # device buffers
            while not cancelled.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return
                except queue.Full:
                    continue

        def worker():
            try:
                for batch in self._batch_reader():
                    put(self.place(batch))
                    if cancelled.is_set():
                        return
            except Exception as e:  # reaches the consumer
                err.append(e)
            finally:
                put(stop)

        t = threading.Thread(target=worker, name=THREAD_NAME, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is stop:
                    break
                yield self.ready(item)
        finally:
            cancelled.set()
            while not q.empty():
                try:
                    q.get_nowait()
                except queue.Empty:
                    break
            t.join(timeout=5)
        if err:
            raise err[0]


def _collate(samples):
    """Stack a list of tuple-samples into batched numpy arrays."""
    if isinstance(samples[0], (tuple, list)):
        return tuple(np.stack([np.asarray(s[i]) for s in samples])
                     for i in range(len(samples[0])))
    if isinstance(samples[0], dict):
        return {k: np.stack([np.asarray(s[k]) for s in samples])
                for k in samples[0]}
    return np.stack([np.asarray(s) for s in samples])


def batch(reader, batch_size, drop_last=True):
    """Compose a sample reader into a batch reader (ref:
    python/paddle/batch.py)."""
    def batch_reader():
        buf = []
        for sample in reader():
            buf.append(sample)
            if len(buf) == batch_size:
                yield _collate(buf)
                buf = []
        if buf and not drop_last:
            yield _collate(buf)
    return batch_reader


def shuffle(reader, buf_size, seed=None):
    """Shuffle a sample reader through a buffer of ``buf_size`` samples
    with ``np.random.RandomState(seed)`` (ref: ``loader.py:171``): the
    reference's order for the same seed."""
    def shuffled():
        rng = np.random.RandomState(seed)
        pool = []
        for s in reader():
            pool.append(s)
            if len(pool) >= buf_size:
                rng.shuffle(pool)
                yield from pool
                pool = []
        rng.shuffle(pool)
        yield from pool
    return shuffled
