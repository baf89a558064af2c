"""In-memory and file-backed datasets and the synthetic streams (ref:
``paddle_tpu/data/dataset.py``), in numpy: the port's own copy. The
synthetic streams draw from ``np.random.RandomState(seed)`` exactly as the
reference's do, so both packages yield the same samples."""

import numpy as np

from paddle_tpu_torch.core.enforce import enforce


class InMemoryDataset:
    """Load, shuffle, iterate (ref: ``dataset.py:12``). The global
    shuffle is host-local: every rank seeds it alike and takes its
    ``rank::world`` part."""

    def __init__(self, samples=None):
        self._samples = list(samples) if samples is not None else []

    def load(self, samples):
        self._samples.extend(samples)

    def global_shuffle(self, seed=0, rank=0, world=1):
        rng = np.random.RandomState(seed)
        idx = rng.permutation(len(self._samples))
        self._samples = [self._samples[i] for i in idx[rank::world]]
        return self

    def reader(self):
        def r():
            yield from self._samples
        return r

    def readers(self, n):
        """``n`` round-robin shard readers, one per ingestion thread."""
        m = max(n, 1)

        def make(i):
            def r():
                yield from self._samples[i::m]
            return r
        return [make(i) for i in range(m)]

    def __len__(self):
        return len(self._samples)


def synthetic_images(n, shape=(3, 32, 32), num_classes=10, seed=0):
    """CIFAR-like samples ``(image f32 shape, label int64 [1])`` (ref:
    ``dataset.py:51``)."""
    rng = np.random.RandomState(seed)
    for _ in range(n):
        yield (rng.rand(*shape).astype(np.float32),
               rng.randint(num_classes, size=(1,)).astype(np.int64))


def synthetic_mnist(n, seed=0):
    """MNIST-like samples ``(image f32 [1, 28, 28], label int64 [1])``
    (ref: ``dataset.py:60``)."""
    rng = np.random.RandomState(seed)
    for _ in range(n):
        yield (rng.rand(1, 28, 28).astype(np.float32),
               rng.randint(10, size=(1,)).astype(np.int64))


def synthetic_tokens(n, seq_len=128, vocab=30522, seed=0):
    """BERT-like samples ``(ids int32 [seq_len],)`` (ref:
    ``dataset.py:67``)."""
    rng = np.random.RandomState(seed)
    for _ in range(n):
        yield (rng.randint(vocab, size=(seq_len,)).astype(np.int32),)


def synthetic_ctr(n, num_sparse=26, num_dense=13, vocab=10000, seed=0):
    """Criteo-like samples ``(dense f32 [num_dense], sparse int32
    [num_sparse], label f32 [1])`` for DeepFM and Wide&Deep (ref:
    ``dataset.py:75``)."""
    rng = np.random.RandomState(seed)
    for _ in range(n):
        dense = rng.rand(num_dense).astype(np.float32)
        sparse = rng.randint(vocab, size=(num_sparse,)).astype(np.int32)
        label = rng.randint(2, size=(1,)).astype(np.float32)
        yield (dense, sparse, label)


class FileDataset:
    """Samples from record files through the native reader (ref:
    ``dataset.py:86``): each record is decoded by ``decode``
    (:func:`native.unpack_numpy_record` by default). :meth:`readers`
    shards the file list, one native reader of ``num_threads`` threads a
    shard. A remote entry (a path with a scheme, ``io/fs.py``) is staged
    to the local cache first, ``num_threads`` at a time."""

    def __init__(self, files, num_threads=2, decode=None):
        from paddle_tpu_torch.data import native
        self.files = list(files)
        enforce(len(self.files) > 0, "FileDataset needs at least one file")
        self._native = native
        self.num_threads = num_threads
        self.decode = decode or native.unpack_numpy_record

    def _read(self, files, num_threads):
        from paddle_tpu_torch.io import fs as _fs
        if any(_fs.split_scheme(f)[0] is not None for f in files):
            from concurrent.futures import ThreadPoolExecutor
            with ThreadPoolExecutor(max_workers=max(num_threads, 1)) as ex:
                files = list(ex.map(_fs.ensure_local, files))
        rd = self._native.NativeRecordReader(files, num_threads=num_threads)
        try:
            for rec in rd:
                yield self.decode(rec)
        finally:
            rd.close()

    def reader(self):
        return lambda: self._read(self.files, self.num_threads)

    def readers(self, n):
        """``min(n, len(files))`` shard readers over ``files[i::m]``."""
        m = max(min(n, len(self.files)), 1)
        return [(lambda i=i: self._read(self.files[i::m], self.num_threads))
                for i in range(m)]
