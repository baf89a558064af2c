"""The word2vec book path on the port, as a user runs it: text -> the
dictionary (``build_dict(..., markers=True)``) -> 5-grams
(``ngram_reader(n=5)``, the book's N) -> record files
(``write_record_file`` over ``numpy_records``) -> the native reader's
threads (``FileDataset``) -> the device -> ``Word2Vec`` (the N-gram LM)
and ``SkipGramNCE`` (center, target) training under Adam.

The corpus is synthetic and seeded: Zipf-distributed words over a fixed
vocabulary, written to a file first (no corpus ships with the
repository, and none is fetched). ``chip_smoke.py``'s ``word2vec`` phase
drives these functions on the card.

CPU:   python3 tools/torch_word2vec.py --device cpu --lines 400 --steps 5
card:  python3 tools/torch_word2vec.py
"""

import argparse
import collections
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

#: the book's N, and the JAX defaults' widths of both models
NGRAM = 5
W2V = dict(embed_dim=32, context=NGRAM - 1, hidden=256)
SKIPGRAM = dict(vocab_size=2048, embed_dim=64, num_neg=16)


def zipf_corpus(path, lines=3000, words=2000, seed=0, a=1.2):
    """``lines`` lines of 4-20 words, each word ``w<k>`` with k drawn from
    a Zipf law of exponent ``a`` folded into ``words`` distinct words."""
    rs = np.random.RandomState(seed)
    with open(path, "w") as f:
        for _ in range(lines):
            ks = (rs.zipf(a, rs.randint(4, 21)) - 1) % words
            f.write(" ".join(f"w{k}" for k in ks) + "\n")
    return path


def book_grams(paths, n=NGRAM):
    """``(word_idx, grams [G, n] int32)`` through the port's parsers."""
    from paddle_tpu_torch.data import build_dict, ngram_reader
    word_idx = build_dict(paths, cutoff=0, markers=True)
    grams = np.asarray(list(ngram_reader(paths, word_idx, n)()), np.int32)
    return word_idx, grams


def write_grams(grams, out_dir, files=4):
    """The grams as ``files`` record files (one ``numpy_records`` record
    a gram, round-robin); returns (paths, the records written)."""
    from paddle_tpu_torch.data import native
    records = [native.numpy_records((g,)) for g in grams]
    paths = []
    for i in range(files):
        path = os.path.join(out_dir, f"grams-{i}.rec")
        native.write_record_file(path, records[i::files])
        paths.append(path)
    return paths, records


def read_grams(paths, threads=2):
    """Every record through ``FileDataset`` (``threads`` native reader
    threads): ``(raw records, grams [G, n], records per second of the
    decoding pass)``. The order is the threads' and varies."""
    from paddle_tpu_torch.data import FileDataset
    raw = list(FileDataset(paths, num_threads=threads,
                           decode=bytes).reader()())
    t0 = time.perf_counter()
    grams = [s[0] for s in FileDataset(paths, num_threads=threads).reader()()]
    rate = len(grams) / (time.perf_counter() - t0)
    return raw, np.stack(grams).astype(np.int32), rate


def same_records(written, read):
    """The records read back are byte for byte those written (as a
    multiset: the reader threads interleave files)."""
    return collections.Counter(written) == collections.Counter(read)


def batches(grams, batch, steps, seed=0):
    """``steps`` batches of ``batch`` rows, a seeded order of the grams
    (sorted first, so the reader's interleaving does not matter)."""
    rows = grams[np.lexsort(grams.T[::-1])]
    order = np.random.RandomState(seed).permutation(len(rows))
    reps = -(-batch * steps // len(rows))
    order = np.concatenate([order] * reps)
    return [rows[order[i * batch:(i + 1) * batch]] for i in range(steps)]


def skipgram_pairs(gram):
    """(center, target) pairs of a batch of grams: the middle word against
    each of the others, ``[B * (n - 1)]`` each."""
    mid = gram.shape[1] // 2
    others = [j for j in range(gram.shape[1]) if j != mid]
    center = np.repeat(gram[:, mid], len(others))
    target = gram[:, others].reshape(-1)
    return center.astype(np.int64), target.astype(np.int64)


def w2v_loss(model, ctx, tgt):
    from paddle_tpu_torch.models.word2vec import lm_loss
    return lm_loss(model(ctx), tgt)


def nce_loss(model, center, target, neg=None):
    return model(center, target, neg).mean()


def make_models(vocab, device, seed=0, lr=1e-3):
    """``(Word2Vec, its Adam, SkipGramNCE, its Adam)`` on ``device``, each
    drawn from ``seed`` on the CPU (so two devices hold equal weights)."""
    from paddle_tpu_torch.models.word2vec import SkipGramNCE, Word2Vec
    from paddle_tpu_torch.optimizer import Adam
    w2v = Word2Vec(vocab_size=vocab, device=device, seed=seed, **W2V)
    sg = SkipGramNCE(device=device, seed=seed, **SKIPGRAM)
    return (w2v, Adam(w2v.parameters(), lr), sg,
            Adam(sg.parameters(), lr))


def negatives(batch_rows, steps, seed=0):
    """SkipGramNCE's negatives for ``steps`` batches, drawn on the CPU
    from ``seed`` (the same for every device)."""
    from paddle_tpu_torch.ops.loss import nce_negatives
    gen = torch.Generator().manual_seed(seed)
    return [nce_negatives(gen, batch_rows, SKIPGRAM["num_neg"],
                          SKIPGRAM["vocab_size"]) for _ in range(steps)]


def step_args(gram, neg, device):
    """Both models' arguments for one batch of grams on ``device``."""
    ctx = torch.from_numpy(gram[:, :-1]).to(device)
    tgt = torch.from_numpy(gram[:, -1:]).to(device)
    center, target = skipgram_pairs(gram)
    return ((ctx, tgt), (torch.from_numpy(center).to(device),
                         torch.from_numpy(target).to(device),
                         None if neg is None else neg.to(device)))


def train(device, vocab, grams_batches, negs, seed=0, models=None):
    """Each model trained over the batches (``models``, else
    :func:`make_models`'s); ``(w2v losses, sg losses, w2v step seconds,
    sg step seconds)``, each step ending on a host read of its loss."""
    w2v, w2v_opt, sg, sg_opt = models or make_models(vocab, device, seed)
    out = ([], [], [], [])
    for gram, neg in zip(grams_batches, negs):
        a, b = step_args(gram, neg, device)
        t0 = time.perf_counter()
        out[0].append(float(w2v_opt.minimize(w2v, w2v_loss, *a)))
        t1 = time.perf_counter()
        out[1].append(float(sg_opt.minimize(sg, nce_loss, *b)))
        t2 = time.perf_counter()
        out[2].append(t1 - t0)
        out[3].append(t2 - t1)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--lines", type=int, default=3000)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--threads", type=int, default=2)
    args = ap.parse_args(argv)
    with tempfile.TemporaryDirectory() as tmp:
        corpus = zipf_corpus(os.path.join(tmp, "corpus.txt"), args.lines)
        word_idx, grams = book_grams([corpus])
        paths, written = write_grams(grams, tmp)
        raw, read, rate = read_grams(paths, args.threads)
    if not same_records(written, raw):
        raise SystemExit("records read back differ from those written")
    bs = batches(read, args.batch, args.steps)
    negs = negatives(args.batch * (NGRAM - 1), args.steps)
    w2v, sg, tw, ts = train(args.device, len(word_idx), bs, negs)
    print(json.dumps(dict(vocab=len(word_idx), grams=len(grams),
                          records_per_s=rate, w2v_losses=w2v,
                          skipgram_losses=sg,
                          w2v_p50_ms=float(np.median(tw)) * 1e3,
                          skipgram_p50_ms=float(np.median(ts)) * 1e3)))


if __name__ == "__main__":
    main()
