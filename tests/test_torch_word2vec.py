"""word2vec on the port against the JAX package, on the CPU: ``Word2Vec``
and ``SkipGramNCE`` through the bridge (losses and gradients, the NCE
loss on the reference's own negatives), ``examples/word2vec_ngram.py``'s
training loop in both packages, and the book path of
``tools/torch_word2vec.py`` (corpus -> dictionary -> 5-grams -> record
files -> the native reader) against the JAX package's parsers."""

import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as pt
from paddle_tpu.models.word2vec import SkipGramNCE as JSkipGram
from paddle_tpu.models.word2vec import Word2Vec as JW2V
from paddle_tpu.models.word2vec import lm_loss as jlm_loss
from paddle_tpu_torch import bridge
from paddle_tpu_torch.models.word2vec import SkipGramNCE, Word2Vec, lm_loss

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools"))
import torch_word2vec as book  # noqa: E402

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-5)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        name = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flat(v, name + "."))
        else:
            out[name] = np.asarray(v)
    return out


def _close_grads(model, jgrads, tol=TOL):
    flat = _flat(jgrads)
    named = dict(model.named_parameters())
    assert sorted(named) == sorted(flat)
    for name, p in named.items():
        np.testing.assert_allclose(p.grad.numpy(), flat[name], err_msg=name,
                                   **tol)


def _np_params(variables):
    return jax.tree_util.tree_map(np.asarray, variables["params"])


def test_word2vec_through_the_bridge():
    j = JW2V(vocab_size=300, embed_dim=16, context=4, hidden=32)
    params = _np_params(j.init(jax.random.key(1)))
    m = bridge.load_params(Word2Vec(300, 16, 4, 32, device="cpu"), params)
    rs = np.random.RandomState(2)
    ctx = rs.randint(0, 300, (24, 4)).astype(np.int32)
    tgt = rs.randint(0, 300, (24, 1)).astype(np.int32)

    def jl(p):
        return jlm_loss(j.apply({"params": p, "state": {}},
                                jnp.asarray(ctx)), jnp.asarray(tgt))
    jv, jg = jax.value_and_grad(jl)(params)
    loss = lm_loss(m(torch.from_numpy(ctx)), torch.from_numpy(tgt))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jv), rtol=1e-5)
    _close_grads(m, jg)


@pytest.mark.parametrize("target_shape", ["flat", "column"])
def test_skipgram_nce_on_the_references_negatives(target_shape):
    v, d, k, b = 200, 12, 6, 16
    j = JSkipGram(vocab_size=v, embed_dim=d, num_neg=k)
    params = _np_params(j.init(jax.random.key(3)))
    assert sorted(_flat(params)) == ["embed.weight", "nce_bias",
                                     "nce_weight"]
    # weights large enough that the loss depends on which negatives came
    params["embed"]["weight"] = params["embed"]["weight"] * 20
    params["nce_weight"] = params["nce_weight"] * 100
    params["nce_bias"] = np.random.RandomState(6).randn(v).astype(
        np.float32)
    m = bridge.load_params(SkipGramNCE(v, d, k, device="cpu"), params)
    rs = np.random.RandomState(4)
    center = rs.randint(0, v, b).astype(np.int32)
    target = rs.randint(0, v, b if target_shape == "flat" else (b, 1))
    target = target.astype(np.int32)
    key = jax.random.key(5)

    def jl(p):
        return j.apply({"params": p, "state": {}}, jnp.asarray(center),
                       jnp.asarray(target), rngs={"nce": key}).mean()
    jv, jg = jax.value_and_grad(jl)(params)
    _, sub = jax.random.split(key)      # Module.rng("nce") hands out sub
    neg = torch.from_numpy(np.array(jax.random.randint(sub, (b, k), 0, v)))
    wrong = torch.from_numpy(np.array(jax.random.randint(key, (b, k), 0, v)))
    other = m(torch.from_numpy(center), torch.from_numpy(target), wrong)
    assert abs(float(other.mean()) - float(jv)) > 1e-3 * abs(float(jv))
    out = m(torch.from_numpy(center), torch.from_numpy(target), neg)
    assert out.shape == (b, 1)
    out.mean().backward()
    np.testing.assert_allclose(float(out.detach().mean()), float(jv),
                               rtol=1e-5)
    _close_grads(m, jg)


def test_skipgram_draws_its_negatives_from_its_own_generator():
    m1 = SkipGramNCE(100, 8, 5, device="cpu", seed=7)
    m2 = SkipGramNCE(100, 8, 5, device="cpu", seed=7)
    n1, n2 = m1.negatives(300), m2.negatives(300)
    assert n1.shape == (300, 5) and torch.equal(n1, n2)
    assert int(n1.min()) >= 0 and int(n1.max()) == 99
    assert not torch.equal(m1.negatives(300), n1)
    c = torch.arange(10)
    assert torch.isfinite(m1(c, c)).all()
    assert torch.equal(m1.embed.weight, m2.embed.weight)
    assert float(m1.embed.weight.abs().max()) <= 0.05


def test_the_examples_loop_in_both_packages(tmp_path):
    """``examples/word2vec_ngram.py``: its corpus, 4-grams through both
    packages' parsers, a shared Embedding and one Linear, 10 steps of
    Adam(5e-2) from the same weights; per-step losses within 1e-4."""
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "examples"))
    import word2vec_ngram as ex
    from paddle_tpu_torch import data as pdata
    from paddle_tpu_torch import nn as pnn
    from paddle_tpu_torch.ops.loss import softmax_with_cross_entropy
    from paddle_tpu_torch.optimizer import Adam
    corpus = str(tmp_path / "corpus.txt")
    with open(corpus, "w") as f:
        f.write(ex.CORPUS)
    word_idx = pt.data.build_dict([corpus], cutoff=0, markers=True)
    assert pdata.build_dict([corpus], cutoff=0, markers=True) == word_idx
    grams = np.asarray(list(pt.data.ngram_reader([corpus], word_idx, 4)()),
                       np.int32)
    np.testing.assert_array_equal(grams, np.asarray(list(
        pdata.ngram_reader([corpus], word_idx, 4)()), np.int32))
    vocab, dim = len(word_idx), 16
    emb = pt.nn.Embedding(vocab, dim)
    fc = pt.nn.Linear(3 * dim, vocab)
    params = {"emb": emb.init(jax.random.key(0))["params"],
              "fc": fc.init(jax.random.key(1))["params"]}
    opt = pt.optimizer.Adam(5e-2)
    state = opt.init(params)
    ctx, tgt = jnp.asarray(grams[:, :-1]), jnp.asarray(grams[:, -1:])

    def loss_fn(p):
        e = emb.apply({"params": p["emb"], "state": {}}, ctx)
        logits = fc.apply({"params": p["fc"], "state": {}},
                          e.reshape(e.shape[0], -1))
        return jnp.mean(pt.ops.loss.softmax_with_cross_entropy(logits, tgt))

    @jax.jit
    def step(p, s):
        value, g = jax.value_and_grad(loss_fn)(p)
        p, s = opt.apply_gradients(p, g, s)
        return value, p, s

    class Net(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.emb = pnn.Embedding(vocab, dim)
            self.fc = pnn.Linear(3 * dim, vocab)

        def forward(self, c):
            e = self.emb(c)
            return self.fc(e.reshape(e.shape[0], -1))

    net = bridge.load_params(Net(), jax.tree_util.tree_map(np.asarray,
                                                           params))
    popt = Adam(net.parameters(), 5e-2)
    pc, pl = torch.from_numpy(grams[:, :-1]), torch.from_numpy(grams[:, -1:])
    want, got = [], []
    for _ in range(10):
        value, params, state = step(params, state)
        want.append(float(value))
        got.append(float(popt.minimize(
            net, lambda m, c, y: softmax_with_cross_entropy(m(c), y).mean(),
            pc, pl)))
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert got[-1] < got[0]


def test_the_book_path_on_the_cpu(tmp_path):
    """The tool's corpus through the port's dictionary, 5-grams, record
    files and two native reader threads, against the JAX package's
    parsers; then three steps of both models on the CPU, finite."""
    corpus = book.zipf_corpus(str(tmp_path / "c.txt"), lines=120, words=300)
    word_idx, grams = book.book_grams([corpus])
    jidx = pt.data.build_dict([corpus], cutoff=0, markers=True)
    assert word_idx == jidx and len(word_idx) <= book.SKIPGRAM["vocab_size"]
    np.testing.assert_array_equal(grams, np.asarray(list(
        pt.data.ngram_reader([corpus], jidx, 5)()), np.int32))
    paths, written = book.write_grams(grams, str(tmp_path))
    raw, read, rate = book.read_grams(paths, threads=2)
    assert book.same_records(written, raw) and rate > 0
    assert sorted(map(tuple, read)) == sorted(map(tuple, grams))
    bs = book.batches(read, 64, 3)
    assert all(b.shape == (64, 5) for b in bs)
    np.testing.assert_array_equal(bs[0], book.batches(grams, 64, 3)[0])
    negs = book.negatives(64 * 4, 3)
    w2v, sg, _, _ = book.train("cpu", len(word_idx), bs, negs)
    assert np.isfinite(w2v).all() and np.isfinite(sg).all()
    again = book.train("cpu", len(word_idx), bs, negs)
    assert again[0] == w2v and again[1] == sg
