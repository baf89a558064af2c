"""The port's CRF ops, edit distance and chunk metrics against the JAX
reference on the CPU (the cases of ``tests/test_ops_crf_seq.py``):
``linear_chain_crf`` and its gradients against ``jax.grad``,
``crf_decoding`` paths and marks (ties included), ``edit_distance``,
``chunk_eval`` in all four schemes, and the ``EditDistance`` and
``ChunkEvaluator`` metrics. Inputs are made with numpy from a seed.

Tolerances: f32 values within 1e-5 (sums in another order); decoded
paths, marks, edit distances and chunk counts exact.
"""

import itertools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.ops import crf as jcrf
from paddle_tpu.ops import metrics_ops as jmo
from paddle_tpu_torch.ops import crf
from paddle_tpu_torch.ops import metrics_ops as mo

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)


def t(a):
    return torch.from_numpy(np.array(np.asarray(a)))


def n(x):
    return x.detach().cpu().numpy()


def _crf_case(seed, B=4, T=6, K=4, lengths=None):
    rs = np.random.RandomState(seed)
    em = rs.randn(B, T, K).astype(np.float32)
    tr = rs.randn(K + 2, K).astype(np.float32)
    lab = rs.randint(0, K, (B, T)).astype(np.int32)
    if lengths is None:
        lengths = rs.randint(1, T + 1, B)
    return em, tr, lab, np.asarray(lengths, np.int32)


def _brute(em, tr, lengths):
    """Every path enumerated: (logZ, best path padded with 0)."""
    start, stop, trans = tr[0], tr[1], tr[2:]
    B, T, K = em.shape
    log_zs, best = [], []
    for b in range(B):
        L = int(lengths[b])
        scores = {}
        for path in itertools.product(range(K), repeat=L):
            s = start[path[0]] + stop[path[-1]]
            s += sum(em[b, i, path[i]] for i in range(L))
            s += sum(trans[path[i], path[i + 1]] for i in range(L - 1))
            scores[path] = s
        vals = np.array(list(scores.values()), np.float64)
        m = vals.max()
        log_zs.append(m + np.log(np.exp(vals - m).sum()))
        top = max(scores, key=scores.get)
        best.append(list(top) + [0] * (T - L))
    return np.array(log_zs), np.array(best)


@pytest.mark.parametrize("seed,lengths", [(7, [4, 2, 3, 1]), (1, None),
                                          (2, [6, 6, 6, 6])])
def test_linear_chain_crf_nll_and_gradients_equal_jaxs(seed, lengths):
    em, tr, lab, lens = _crf_case(seed, lengths=lengths)

    def jl(e, w):
        return jnp.sum(jcrf.linear_chain_crf(e, w, jnp.asarray(lab),
                                             jnp.asarray(lens)))
    jnll, (jge, jgw) = jax.jit(lambda e, w: (
        jcrf.linear_chain_crf(e, w, jnp.asarray(lab), jnp.asarray(lens)),
        jax.grad(jl, argnums=(0, 1))(e, w)))(jnp.asarray(em),
                                             jnp.asarray(tr))
    e, w = t(em).requires_grad_(), t(tr).requires_grad_()
    nll = crf.linear_chain_crf(e, w, t(lab), t(lens))
    nll.sum().backward()
    np.testing.assert_allclose(n(nll), np.asarray(jnll), **TOL)
    np.testing.assert_allclose(n(e.grad), np.asarray(jge), **TOL)
    np.testing.assert_allclose(n(w.grad), np.asarray(jgw), **TOL)
    for b, L in enumerate(lens):          # padding takes no gradient
        assert np.all(n(e.grad)[b, L:] == 0.0)


def test_linear_chain_crf_matches_brute_force():
    em, tr, lab, lens = _crf_case(7, B=3, T=4, K=3, lengths=[4, 2, 3])
    log_z, _ = _brute(em, tr, lens)
    nll = n(crf.linear_chain_crf(t(em), t(tr), t(lab), t(lens)))
    start, stop, trans = tr[0], tr[1], tr[2:]
    for b, L in enumerate(lens):
        p = lab[b, :L]
        s = start[p[0]] + stop[p[-1]] + sum(em[b, i, p[i]] for i in range(L))
        s += sum(trans[p[i], p[i + 1]] for i in range(L - 1))
        np.testing.assert_allclose(nll[b], log_z[b] - s, rtol=1e-4)


@pytest.mark.parametrize("seed,lengths", [(7, [4, 2, 3, 1]), (3, None),
                                          (4, [1, 1, 1, 1])])
def test_crf_decoding_paths_and_marks_equal_jaxs(seed, lengths):
    em, tr, lab, lens = _crf_case(seed, lengths=lengths)
    args = (jnp.asarray(em), jnp.asarray(tr), jnp.asarray(lens))
    jpath, jmarks = jax.jit(lambda *a: (
        jcrf.crf_decoding(*a), jcrf.crf_decoding(*a, jnp.asarray(lab))))(
            *args)
    path = crf.crf_decoding(t(em), t(tr), t(lens))
    assert path.dtype == torch.int32
    np.testing.assert_array_equal(n(path), np.asarray(jpath))
    np.testing.assert_array_equal(
        n(crf.crf_decoding(t(em), t(tr), t(lens), t(lab))),
        np.asarray(jmarks))


def test_crf_decoding_matches_brute_force_and_marks_its_own_path():
    em, tr, _, lens = _crf_case(7, B=3, T=4, K=3, lengths=[4, 2, 3])
    _, best = _brute(em, tr, lens)
    path = n(crf.crf_decoding(t(em), t(tr), t(lens)))
    np.testing.assert_array_equal(path, best)
    marks = n(crf.crf_decoding(t(em), t(tr), t(lens), t(best)))
    mask = np.arange(4)[None] < lens[:, None]
    np.testing.assert_array_equal(marks, mask.astype(np.int32))


@pytest.mark.parametrize("scale", [0.0, 1.0])
def test_crf_decoding_breaks_ties_as_jax_does(scale):
    """Integer scores make many paths tie (all of them at scale 0): the
    lowest tag wins each argmax, as in jnp.argmax."""
    rs = np.random.RandomState(5)
    em = (rs.randint(0, 2, (3, 5, 4)) * scale).astype(np.float32)
    tr = (rs.randint(0, 2, (6, 4)) * scale).astype(np.float32)
    lens = np.array([5, 3, 1], np.int32)
    jpath = np.asarray(jax.jit(jcrf.crf_decoding)(
        jnp.asarray(em), jnp.asarray(tr), jnp.asarray(lens)))
    np.testing.assert_array_equal(
        n(crf.crf_decoding(t(em), t(tr), t(lens))), jpath)


def _levenshtein(a, b):
    dp = list(range(len(b) + 1))
    for i in range(1, len(a) + 1):
        prev = dp[:]
        dp[0] = i
        for j in range(1, len(b) + 1):
            dp[j] = min(prev[j] + 1, dp[j - 1] + 1,
                        prev[j - 1] + (a[i - 1] != b[j - 1]))
    return dp[len(b)]


@pytest.mark.parametrize("normalized", [False, True])
def test_edit_distance_equals_jaxs_exactly(normalized):
    rs = np.random.RandomState(0)
    B, T1, T2 = 6, 7, 6
    hyp = rs.randint(0, 4, (B, T1)).astype(np.int32)
    ref = rs.randint(0, 4, (B, T2)).astype(np.int32)
    hyp_len = rs.randint(0, T1 + 1, B).astype(np.int32)
    ref_len = rs.randint(1, T2 + 1, B).astype(np.int32)
    hyp_len[0] = 0                          # an empty hypothesis
    want = np.asarray(jax.jit(jcrf.edit_distance, static_argnums=4)(
        jnp.asarray(hyp), jnp.asarray(hyp_len), jnp.asarray(ref),
        jnp.asarray(ref_len), normalized))
    got = n(crf.edit_distance(t(hyp), t(hyp_len), t(ref), t(ref_len),
                              normalized=normalized))
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    for b in range(B):
        d = _levenshtein(list(hyp[b, :hyp_len[b]]), list(ref[b, :ref_len[b]]))
        np.testing.assert_allclose(
            got[b], d / ref_len[b] if normalized else d, rtol=1e-6)


#: chunk-tag layouts: (scheme, tags a chunk type)
SCHEMES = (("IOB", 2), ("IOE", 2), ("IOBES", 4), ("plain", 1))


@pytest.mark.parametrize("scheme,per", SCHEMES, ids=[s for s, _ in SCHEMES])
@pytest.mark.parametrize("excluded", [(), (1,)])
def test_chunk_eval_counts_equal_jaxs(scheme, per, excluded):
    rs = np.random.RandomState(len(scheme) + len(excluded))
    types = 3
    B, T = 8, 12
    # tags in [0, types * per] (the last is Outside), some out of range
    label = rs.randint(-1, types * per + 2, (B, T))
    infer = np.where(rs.rand(B, T) < 0.7, label,
                     rs.randint(0, types * per + 1, (B, T)))
    lengths = rs.randint(1, T + 1, B)
    got = mo.chunk_eval(t(infer), t(label), t(lengths), scheme, types,
                        excluded)
    want = jmo.chunk_eval(infer, label, lengths, scheme, types, excluded)
    assert got[3:] == tuple(want[3:])
    assert got[3] > 0 and got[5] > 0
    np.testing.assert_allclose(got[:3], want[:3], rtol=0, atol=1e-12)


@pytest.mark.parametrize("case", [
    ("IOB", 1, [[0, 1, 2, 0, 1, 1]], [[0, 1, 2, 0, 2, 2]], (), (2, 2, 1)),
    ("IOBES", 1, [[3, 0, 1, 2, 4]], [[3, 0, 1, 2, 4]], (), (2, 2, 2)),
    ("plain", 1, [[0, 1]], [[0, 0]], (), (1, 1, 0)),
    ("IOB", 2, [[0, 1, 2, 3]], [[0, 1, 2, 3]], (1,), (1, 1, 1))])
def test_chunk_eval_reference_cases(case):
    scheme, types, label, infer, excl, counts = case
    L = np.array([len(label[0])])
    got = mo.chunk_eval(np.array(infer), np.array(label), L, scheme, types,
                        excl)
    assert got[3:] == counts
    assert got == jmo.chunk_eval(np.array(infer), np.array(label), L, scheme,
                                 types, excl)


def test_edit_distance_and_chunk_evaluator_equal_the_references():
    from paddle_tpu.metrics import ChunkEvaluator as JChunk
    from paddle_tpu.metrics import CompositeMetric as JComposite
    from paddle_tpu.metrics import EditDistance as JEdit
    from paddle_tpu_torch.metrics import (ChunkEvaluator, CompositeMetric,
                                          EditDistance)
    rs = np.random.RandomState(3)
    pairs = [(rs.randint(0, 5, rs.randint(0, 8)),
              rs.randint(0, 5, rs.randint(0, 8))) for _ in range(12)]
    for normalized in (True, False):
        mine, ref = EditDistance(), JEdit()
        for h, r in pairs:
            mine.update([t(h)], [t(r)], normalized=normalized)
            ref.update([h], [r], normalized=normalized)
        assert mine.eval() == ref.eval() and mine.count == ref.count
    mine, ref = ChunkEvaluator(), JChunk()
    for _ in range(3):
        label = rs.randint(0, 5, (4, 9))
        infer = np.where(rs.rand(4, 9) < 0.6, label, rs.randint(0, 5, (4, 9)))
        lengths = rs.randint(1, 10, 4)
        counts = mo.chunk_eval(t(infer), t(label), t(lengths), "IOB", 2)[3:]
        mine.update(*counts)
        ref.update(*jmo.chunk_eval(infer, label, lengths, "IOB", 2)[3:])
    assert mine.eval() == ref.eval()
    both, jboth = CompositeMetric(), JComposite()
    both.add_metric(ChunkEvaluator())
    jboth.add_metric(JChunk())
    both.update(5, 4, 3)
    jboth.update(5, 4, 3)
    assert both.eval() == jboth.eval()
