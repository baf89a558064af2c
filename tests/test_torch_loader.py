"""The port's DataLoader (``paddle_tpu_torch/data/loader.py``) against the
JAX package's: ``from_generator`` with and without the seeded shuffle
buffer (full and ragged last batches, tuple and dict samples) and
``from_batch_generator`` yield the same batches in the same order; an
early ``break`` ends the prefetch thread; a reader's error reaches the
consumer; ``place`` on the CPU gives plain tensors; a mesh and a missing
card raise."""

import threading

import numpy as np
import pytest
import torch

from paddle_tpu.data.loader import DataLoader as JLoader
from paddle_tpu_torch.core.enforce import EnforceError
from paddle_tpu_torch.data import loader as ploader
from paddle_tpu_torch.data.loader import DataLoader


def _samples(n, seed, kind="tuple"):
    def gen():
        rs = np.random.RandomState(seed)
        for i in range(n):
            img = rs.standard_normal((3, 4, 4)).astype(np.float32)
            label = np.int32(rs.randint(0, 10))   # x64 off: jax keeps int32
            yield ((img, label) if kind == "tuple"
                   else {"image": img, "label": label, "index": np.int32(i)})
    return gen


def _as_numpy(batch):
    if isinstance(batch, (tuple, list)):
        return [_as_numpy(b) for b in batch]
    if isinstance(batch, dict):
        return {k: _as_numpy(v) for k, v in batch.items()}
    return np.asarray(batch)


def _assert_same(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        g, w = _as_numpy(g), _as_numpy(w)
        if isinstance(w, dict):      # jax's tree_map sorts the keys
            assert sorted(g) == sorted(w)
            leaves = [(g[k], w[k]) for k in w]
        else:
            leaves = zip(g, w)
        for a, b in leaves:
            assert a.dtype == b.dtype and a.shape == b.shape
            assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("kind", ["tuple", "dict"])
@pytest.mark.parametrize("shuffle,drop_last,buffer", [
    (False, True, 1024), (True, True, 8), (True, False, 5),
    (True, True, 1024), (False, False, 1024)])
def test_from_generator_yields_the_jax_batches_in_order(kind, shuffle,
                                                        drop_last, buffer):
    kw = dict(batch_size=4, shuffle=shuffle, shuffle_buffer=buffer, seed=3,
              drop_last=drop_last)
    gen = _samples(23, seed=1, kind=kind)
    got = list(DataLoader.from_generator(gen, device="cpu", **kw))
    want = list(JLoader.from_generator(gen, **kw))
    assert all(isinstance(t, torch.Tensor)
               for t in (got[0].values() if kind == "dict" else got[0]))
    _assert_same(got, want)
    assert len(got) == (5 if drop_last else 6)


def test_from_batch_generator_matches_jax():
    def batches():
        rs = np.random.RandomState(4)
        for _ in range(5):
            yield (rs.randint(0, 100, (2, 8)).astype(np.int32),
                   rs.standard_normal((2,)).astype(np.float32))
    got = list(DataLoader.from_batch_generator(batches, prefetch=1,
                                               device="cpu"))
    _assert_same(got, list(JLoader.from_batch_generator(batches)))


def _loader_threads():
    return [t for t in threading.enumerate()
            if t.name == ploader.THREAD_NAME and t.is_alive()]


def test_early_break_ends_the_prefetch_thread():
    """The consumer stops after one batch of an endless reader with a
    full prefetch queue: the thread sees the cancellation and ends."""
    def endless():
        i = 0
        while True:
            yield (np.full((2, 3), i, np.float32),)
            i += 1
    loader = DataLoader.from_batch_generator(endless, prefetch=2,
                                             device="cpu")
    it = iter(loader)
    first = next(it)
    assert first[0][0, 0].item() == 0.0
    assert _loader_threads()
    it.close()                         # what an early `break` does
    assert not _loader_threads()
    for batch in loader:               # and the `break` form itself
        break
    assert not _loader_threads()


def test_a_reader_error_reaches_the_consumer():
    def failing():
        yield (np.zeros(2, np.float32),)
        raise ValueError("reader broke at batch 1")
    got = []
    with pytest.raises(ValueError, match="reader broke"):
        for batch in DataLoader.from_batch_generator(failing, device="cpu"):
            got.append(batch)
    assert len(got) == 1
    assert not _loader_threads()


def test_place_on_the_cpu_gives_plain_tensors_it_does_not_share():
    loader = DataLoader(None, device="cpu")
    host = {"ids": np.arange(6, dtype=np.int32).reshape(1, 6),
            "x": [np.ones(3, np.float32)]}
    placed = loader.place(host)
    assert placed["ids"].dtype == torch.int32
    assert placed["ids"].device.type == "cpu"
    assert DataLoader.ready(placed) is placed
    host["ids"][0, 0] = 99
    assert placed["ids"][0, 0].item() == 0     # a copy, not a view
    assert placed["x"][0].tolist() == [1.0, 1.0, 1.0]


def test_a_stager_places_as_the_loader_does():
    """The engine's stager is the loader's placement alone: on the CPU a
    copy as plain tensors, ``ready`` the identity."""
    stager = ploader.Stager(torch.device("cpu"))
    host = (np.arange(6, dtype=np.int32).reshape(1, 6),)
    placed = stager.place(host)
    assert torch.equal(placed[0], torch.from_numpy(host[0]))
    assert ploader.Stager.ready(placed) is placed
    host[0][0, 0] = 99
    assert placed[0][0, 0].item() == 0
    assert isinstance(DataLoader(None, device="cpu")._stager, ploader.Stager)


def test_prefetch_default_is_the_reader_queue_size_setting():
    assert ploader.configure()["reader_queue_size"] == 2
    assert DataLoader(None, device="cpu")._prefetch == 2
    assert DataLoader(None, prefetch=5, device="cpu")._prefetch == 5


def test_mesh_and_a_missing_card_raise():
    with pytest.raises(EnforceError, match="mesh"):
        DataLoader(None, mesh=object(), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(EnforceError, match="no CUDA device"):
            DataLoader(None)
