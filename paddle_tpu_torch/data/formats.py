"""Offline dataset-format parsers (ref: ``paddle_tpu/data/formats.py``),
the port's own copy in host Python and numpy.

Point them at files already on disk; they yield the sample streams the
reference's readers yield:

  * IDX (MNIST images and labels; big-endian, magic-typed, optionally
    gzipped): :func:`read_idx`, :func:`mnist_reader`.
  * CIFAR python pickle batches inside a ``.tar.gz``: :func:`cifar_reader`.
  * Tokenized text with frequency-cutoff dictionaries (the ``<unk>``,
    ``<s>`` and ``<e>`` conventions): :func:`tokenize_text`,
    :func:`build_dict`, :func:`corpus_reader` and :func:`ngram_reader`,
    the word2vec book path's feed.
"""

import collections
import gzip
import pickle
import string
import tarfile

import numpy as np

__all__ = [
    "read_idx", "mnist_reader", "cifar_reader", "tokenize_text",
    "build_dict", "corpus_reader", "ngram_reader",
]

# IDX dtype codes (the format's own table; mnist.py relies on 0x08 only)
_IDX_DTYPES = {
    0x08: np.uint8, 0x09: np.int8, 0x0B: np.int16,
    0x0C: np.int32, 0x0D: np.float32, 0x0E: np.float64,
}


def _read_maybe_gzip(path):
    with open(path, "rb") as f:
        raw = f.read()
    if raw[:2] == b"\x1f\x8b":
        raw = gzip.decompress(raw)
    return raw


def read_idx(path):
    """Parse one IDX file (optionally gzipped) into an ndarray.

    Ref mnist.py:41 — the reference inlines this struct walk for the two
    MNIST layouts; this is the general form: magic = 0x0000 | dtype |
    ndim, then ndim big-endian uint32 dims, then row-major payload.
    """
    buf = _read_maybe_gzip(path)
    if len(buf) < 4 or buf[0] != 0 or buf[1] != 0:
        raise ValueError(f"{path}: not an IDX file (bad magic)")
    dt_code, ndim = buf[2], buf[3]
    if dt_code not in _IDX_DTYPES:
        raise ValueError(f"{path}: unknown IDX dtype 0x{dt_code:02x}")
    dtype = np.dtype(_IDX_DTYPES[dt_code]).newbyteorder(">")
    head = 4 + 4 * ndim
    if len(buf) < head:
        raise ValueError(f"{path}: IDX header truncated")
    dims = [int.from_bytes(buf[4 + 4 * i:8 + 4 * i], "big")
            for i in range(ndim)]
    n = int(np.prod(dims)) if dims else 1
    if len(buf) - head < n * dtype.itemsize:
        raise ValueError(f"{path}: IDX payload truncated "
                         f"({len(buf) - head} of {n * dtype.itemsize} "
                         "bytes)")
    return np.frombuffer(buf, dtype, count=n, offset=head).reshape(dims)


def mnist_reader(image_path, label_path):
    """Yield (image[784] float32 in [-1, 1], label int) pairs.

    Ref mnist.py:41 reader_creator — same normalization
    (x / 255 * 2 - 1) and flat-image convention the book examples feed.
    """
    images = read_idx(image_path)
    labels = read_idx(label_path)
    if images.ndim != 3 or labels.ndim != 1:
        raise ValueError("expected idx3 images + idx1 labels")
    if images.shape[0] != labels.shape[0]:
        raise ValueError(
            f"image/label count mismatch: {images.shape[0]} vs "
            f"{labels.shape[0]}")
    # keep the uint8 array; normalize per sample at yield time (4x less
    # resident memory than materializing the float32 copy up front)
    flat = images.reshape(images.shape[0], -1)

    def reader():
        for x, y in zip(flat, labels):
            yield x.astype(np.float32) / 255.0 * 2.0 - 1.0, int(y)

    return reader


def cifar_reader(tar_path, sub_name):
    """Yield (image[3072] float32 in [0, 1], label int) from a CIFAR
    python-pickle tarball.

    Ref cifar.py:48 reader_creator — same member filter (`sub_name in
    name`, e.g. "data_batch" / "test_batch" / "train"), same bytes-keyed
    pickle protocol, same labels-or-fine_labels fallback and /255 scale.
    """
    def reader():
        with tarfile.open(tar_path, mode="r") as f:
            names = [m.name for m in f if sub_name in m.name]
            for name in sorted(names):
                batch = pickle.load(f.extractfile(name), encoding="bytes")
                data = batch[b"data"]
                labels = batch.get(b"labels",
                                   batch.get(b"fine_labels"))
                if labels is None:
                    raise ValueError(f"{tar_path}:{name}: no labels")
                for sample, label in zip(data, labels):
                    yield (np.asarray(sample, np.float32) / 255.0,
                           int(label))

    return reader


def tokenize_text(path):
    """Yield one token list per line: punctuation stripped, lowercased,
    whitespace-split (ref imdb.py:39 tokenize — same ad-hoc rule, applied
    per line of a local file instead of per tar member)."""
    table = str.maketrans("", "", string.punctuation)
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            toks = line.rstrip("\n\r").translate(table).lower().split()
            if toks:
                yield toks


def build_dict(paths, cutoff=0, markers=False):
    """word -> id over the corpus, most-frequent-first, ties broken
    alphabetically; words with freq <= cutoff dropped; '<unk>' appended
    last (ref imdb.py:59). markers=True also counts '<s>'/'<e>' once per
    line, the imikolov.py:54 LM convention."""
    freq = collections.defaultdict(int)
    for p in paths:
        for toks in tokenize_text(p):
            for w in toks:
                freq[w] += 1
            if markers:
                freq["<s>"] += 1
                freq["<e>"] += 1
    freq.pop("<unk>", None)
    kept = [kv for kv in freq.items() if kv[1] > cutoff]
    kept.sort(key=lambda kv: (-kv[1], kv[0]))
    word_idx = {w: i for i, (w, _) in enumerate(kept)}
    word_idx["<unk>"] = len(word_idx)
    return word_idx


def corpus_reader(paths, word_idx, label=None):
    """Yield id-sequences (or (ids, label) when label is not None) —
    ref imdb.py:79 reader_creator with the pos/neg tar patterns replaced
    by explicit file lists."""
    unk = word_idx["<unk>"]

    def reader():
        for p in paths:
            for toks in tokenize_text(p):
                ids = [word_idx.get(w, unk) for w in toks]
                yield ids if label is None else (ids, label)

    return reader


def ngram_reader(paths, word_idx, n):
    """Sliding n-gram windows over '<s>' + line + '<e>' — ref
    imikolov.py:92 (the word-embedding book example's feed)."""
    unk = word_idx["<unk>"]

    def reader():
        for p in paths:
            for toks in tokenize_text(p):
                l = ["<s>"] + toks + ["<e>"]
                if len(l) < n:
                    continue
                ids = [word_idx.get(w, unk) for w in l]
                for i in range(n, len(ids) + 1):
                    yield tuple(ids[i - n:i])

    return reader
