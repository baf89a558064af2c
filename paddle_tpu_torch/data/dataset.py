"""In-memory datasets and the synthetic CTR stream (ref:
``paddle_tpu/data/dataset.py``), in numpy: the port's own copy."""

import numpy as np


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
