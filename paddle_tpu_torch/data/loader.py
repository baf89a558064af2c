"""Batching of sample readers (ref: ``paddle_tpu/data/loader.py``): the
parts ``Trainer.train(batch_size=)`` uses. Samples are tuples (or dicts)
of numpy arrays; a batch stacks them along a new leading axis."""

import numpy as np


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
