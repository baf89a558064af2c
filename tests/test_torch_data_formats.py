"""The port's data pipeline against the JAX package's, on the CPU: the
format parsers on the same files (IDX plain and gzipped, a CIFAR pickle
tarball, a text corpus through the dictionary, corpus and n-gram
readers), the native record reader built from ``csrc/dataio/dataio.cc``
into the port's own build directory (records through both packages'
readers over several threads and epochs, byte for byte), ``FileDataset``
and its shards, the synthetic streams, ``shuffle`` and the reader
shims."""

import collections
import gzip
import io
import os
import pickle
import tarfile

import numpy as np
import pytest

import paddle_tpu.data as jdata
import paddle_tpu_torch.data as pdata
from paddle_tpu.data import native as jnative
from paddle_tpu_torch.data import native as pnative

CORPUS = """The quick brown fox jumps over the lazy dog!
the lazy dog sleeps, while the quick fox runs
a quick brown fox is quicker than a lazy dog

the dog and the fox are friends in the field
ox
"""


def _idx(path, arr, code, gz=False):
    head = bytes([0, 0, code, arr.ndim]) + b"".join(
        int(d).to_bytes(4, "big") for d in arr.shape)
    body = arr.astype(arr.dtype.newbyteorder(">")).tobytes()
    raw = head + body
    with open(path, "wb") as f:
        f.write(gzip.compress(raw) if gz else raw)


@pytest.fixture()
def corpus(tmp_path):
    a, b = tmp_path / "a.txt", tmp_path / "b.txt"
    a.write_text(CORPUS)
    b.write_text("the fox, the dog.\nUnseen words here\n")
    return [str(a), str(b)]


def _same_stream(got, want):
    got, want = list(got), list(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if isinstance(w, tuple):
            assert len(g) == len(w)
            for a, b in zip(g, w):
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        else:
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


@pytest.mark.parametrize("gz", [False, True])
def test_idx_and_mnist_reader(tmp_path, gz):
    rs = np.random.RandomState(0)
    imgs = rs.randint(0, 256, (5, 4, 3)).astype(np.uint8)
    labels = rs.randint(0, 10, 5).astype(np.uint8)
    ip, lp = str(tmp_path / "img.idx"), str(tmp_path / "lab.idx")
    _idx(ip, imgs, 0x08, gz)
    _idx(lp, labels, 0x08, gz)
    f32 = str(tmp_path / "f.idx")
    _idx(f32, rs.randn(2, 3).astype(np.float32), 0x0D, gz)
    for path in (ip, lp, f32):
        np.testing.assert_array_equal(pdata.read_idx(path),
                                      jdata.read_idx(path))
    _same_stream(pdata.mnist_reader(ip, lp)(), jdata.mnist_reader(ip, lp)())
    bad = tmp_path / "bad.idx"
    bad.write_bytes(b"\x01\x00\x08\x01")
    with pytest.raises(ValueError):
        pdata.read_idx(str(bad))


def test_cifar_reader(tmp_path):
    rs = np.random.RandomState(1)
    path = str(tmp_path / "cifar.tar.gz")
    with tarfile.open(path, "w:gz") as tar:
        for name, key in (("cifar/data_batch_1", b"labels"),
                          ("cifar/data_batch_2", b"labels"),
                          ("cifar/test_batch", b"fine_labels")):
            blob = pickle.dumps({b"data": rs.randint(0, 256, (3, 12)).astype(
                np.uint8), key: list(rs.randint(0, 10, 3))})
            info = tarfile.TarInfo(name)
            info.size = len(blob)
            tar.addfile(info, io.BytesIO(blob))
    for sub in ("data_batch", "test_batch"):
        _same_stream(pdata.cifar_reader(path, sub)(),
                     jdata.cifar_reader(path, sub)())


def test_text_dictionary_and_readers(corpus):
    assert list(pdata.tokenize_text(corpus[0])) == list(
        jdata.tokenize_text(corpus[0]))
    for cutoff in (0, 1, 2):
        for markers in (False, True):
            want = jdata.build_dict(corpus, cutoff=cutoff, markers=markers)
            got = pdata.build_dict(corpus, cutoff=cutoff, markers=markers)
            assert list(got.items()) == list(want.items())
    wi = pdata.build_dict(corpus, cutoff=1, markers=True)
    assert wi["<unk>"] == len(wi) - 1 and wi["the"] == 0
    _same_stream(pdata.corpus_reader(corpus, wi)(),
                 jdata.corpus_reader(corpus, wi)())
    _same_stream(pdata.corpus_reader(corpus, wi, label=1)(),
                 jdata.corpus_reader(corpus, wi, label=1)())
    for n in (2, 5, 9):
        got = list(pdata.ngram_reader(corpus, wi, n)())
        assert got == list(jdata.ngram_reader(corpus, wi, n)())
        assert all(len(g) == n for g in got)


def test_native_library_is_the_ports_own_build():
    assert pnative.available()
    lib = pnative.build()
    assert os.path.dirname(os.path.dirname(lib)) == pnative.BUILD_ROOT
    assert os.path.basename(lib) == pnative.LIB_NAME
    assert pnative.SOURCE.endswith(os.path.join("csrc", "dataio",
                                                "dataio.cc"))
    assert pnative.build() == lib          # built once


def _records(seed, n):
    rs = np.random.RandomState(seed)
    return [pnative.numpy_records((rs.randint(0, 100, rs.randint(1, 9))
                                   .astype(np.int32),
                                   rs.randn(2, 3).astype(np.float32)))
            for _ in range(n)]


@pytest.mark.skipif(not jnative.available(),
                    reason="the JAX package's native library is not built")
@pytest.mark.parametrize("threads,epochs,seed", [(1, 1, 0), (3, 2, 0),
                                                 (2, 3, 7)])
def test_native_round_trip_against_the_reference(tmp_path, threads, epochs,
                                                 seed):
    files = []
    for i in range(4):
        recs = _records(i, 5 + i)
        path = str(tmp_path / f"part{i}.rec")
        (pnative if i % 2 else jnative).write_record_file(path, recs)
        files.append(path)
    got = list(pnative.NativeRecordReader(files, num_threads=threads,
                                          epochs=epochs, shuffle_seed=seed))
    want = list(jnative.NativeRecordReader(files, num_threads=threads,
                                           epochs=epochs, shuffle_seed=seed))
    assert len(got) == (5 + 6 + 7 + 8) * epochs
    assert collections.Counter(got) == collections.Counter(want)
    written = [r for i in range(4) for r in _records(i, 5 + i)]
    assert collections.Counter(got) == collections.Counter(written * epochs)
    if threads == 1 and seed == 0:
        assert got == want == written * epochs
    for g in got[:3]:
        a, b = pnative.unpack_numpy_record(g)
        ja, jb = jnative.unpack_numpy_record(g)
        np.testing.assert_array_equal(a, ja)
        np.testing.assert_array_equal(b, jb)


def test_native_reader_errors(tmp_path):
    with pytest.raises(IOError):
        pnative.NativeRecordReader([str(tmp_path / "missing.rec")])
    with pytest.raises(RuntimeError):
        pnative.NativeRecordReader([])
    big = str(tmp_path / "big.rec")
    pnative.write_record_file(big, [b"x" * 64])
    rd = pnative.NativeRecordReader([big], max_record_bytes=16)
    with pytest.raises(IOError):
        next(rd)
    rd.close()
    empty = str(tmp_path / "empty.rec")
    pnative.write_record_file(empty, [b"", b"ab", b""])
    assert list(pnative.NativeRecordReader([empty])) == [b"", b"ab", b""]


def test_file_dataset_and_its_shards(tmp_path):
    files = []
    for i in range(3):
        path = str(tmp_path / f"s{i}.rec")
        pnative.write_record_file(path, _records(10 + i, 4))
        files.append(path)
    pds = pdata.FileDataset(files, num_threads=2)
    jds = jdata.FileDataset(files, num_threads=2)

    def key(sample):
        return tuple(np.asarray(a).tobytes() for a in sample)
    all_p = collections.Counter(key(s) for s in pds.reader()())
    assert all_p == collections.Counter(key(s) for s in jds.reader()())
    assert sum(all_p.values()) == 12
    for n in (1, 2, 5):
        pshards = pds.readers(n)
        jshards = jds.readers(n)
        assert len(pshards) == len(jshards) == min(n, 3)
        for ps, js in zip(pshards, jshards):
            assert collections.Counter(key(s) for s in ps()) == \
                collections.Counter(key(s) for s in js())
    with pytest.raises(Exception):
        pdata.FileDataset([])


def test_synthetic_streams_shuffle_and_reader_shims():
    for name, kw in (("synthetic_images", dict(shape=(2, 3, 3))),
                     ("synthetic_mnist", {}),
                     ("synthetic_tokens", dict(seq_len=7, vocab=50)),
                     ("synthetic_ctr", dict(vocab=30))):
        _same_stream(getattr(pdata, name)(4, seed=3, **kw),
                     getattr(jdata, name)(4, seed=3, **kw))

    def reader():
        yield from range(23)
    for buf in (1, 5, 50):
        assert list(pdata.shuffle(reader, buf, seed=4)()) == list(
            jdata.shuffle(reader, buf, seed=4)())
    assert pdata.double_buffer(reader) is reader
    with pytest.raises(NotImplementedError):
        pdata.py_reader()
    with pytest.raises(NotImplementedError):
        jdata.py_reader()
