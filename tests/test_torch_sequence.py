"""The port's ragged batches and sequence, text-matching, nets and metric
ops against the JAX reference on the CPU: ``core/ragged.py`` (both
containers, the buckets), every op of ``ops/sequence.py`` (empty rows in
the max/min/first/last pools), ``ops/text_match.py`` (ties in the top-k
pooling, its gradient against ``jax.grad``), ``ops/nets.py``,
``ops/metrics_ops.py`` and the ``SequenceConv``/``RowConv`` layers
through the weight bridge. Inputs are made with numpy from a seed (the
cases of ``tests/test_ops_crf_seq.py``, ``test_ops_misc.py`` and
``test_ops_tail.py``).

Tolerances: f32 within 1e-5 (sums and products in another order);
integer outputs, lengths and offsets exact.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.core import ragged as jrg
from paddle_tpu.ops import metrics_ops as jmo
from paddle_tpu.ops import nets as jnets
from paddle_tpu.ops import sequence as jseq
from paddle_tpu.ops import text_match as jtm
from paddle_tpu_torch.core import ragged as rg
from paddle_tpu_torch.ops import metrics_ops as mo
from paddle_tpu_torch.ops import nets
from paddle_tpu_torch.ops import sequence as seq
from paddle_tpu_torch.ops import text_match as tm

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)


def t(a):
    return torch.from_numpy(np.array(np.asarray(a)))


def n(x):
    return x.detach().cpu().numpy()


def same(got, want, exact=False):
    """A port result (tensor, RaggedBatch or tuple of them) against the
    reference's."""
    if isinstance(got, rg.RaggedBatch):
        same(got.values, want.values, exact)
        same(got.row_lengths, want.row_lengths, True)
        return
    if isinstance(got, (tuple, list)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            same(g, w, exact)
        return
    g = n(got) if isinstance(got, torch.Tensor) else np.asarray(got)
    w = np.asarray(want)
    assert g.shape == w.shape, (g.shape, w.shape)
    if exact or w.dtype.kind in "iub":
        np.testing.assert_array_equal(g, w)
    else:
        np.testing.assert_allclose(g, w, **TOL)


def pair(seqs, dtype=None):
    """The same ragged batch in both packages."""
    return (rg.RaggedBatch.from_list(seqs, dtype, device="cpu"),
            jrg.RaggedBatch.from_list(seqs, dtype))


def feats(rs, lengths, d=3):
    return [rs.randn(L, d).astype(np.float32) for L in lengths]


# ---------------------------------------------------------------- ragged

def test_ragged_batch_layout_equals_jaxs():
    rs = np.random.RandomState(0)
    prb, jrb = pair(feats(rs, [3, 1, 4, 2]))
    same(prb.offsets(), jrb.offsets(), True)
    same(prb.segment_ids(), jrb.segment_ids(), True)
    assert prb.offsets().dtype == prb.segment_ids().dtype == torch.int32
    for max_len, pad in ((None, 0), (5, 0), (4, -1.5), (6, 2)):
        same(prb.to_padded(max_len, pad), jrb.to_padded(max_len, pad))
    dense, lens = jrb.to_padded(5)
    same(rg.RaggedBatch.from_padded(t(dense), t(jrb.row_lengths)),
         jrg.RaggedBatch.from_padded(dense, jrb.row_lengths))
    ints, jints = pair([[1, 2, 3], [4], [5, 6]])
    assert ints.values.dtype == torch.int32 and ints.nrows == 3
    same(ints.to_padded(4, 9), jints.to_padded(4, 9))


def test_nested_ragged_equals_jaxs():
    nested = [[[1, 2, 3], [4]], [[5, 6]], [[7], [8, 9], [10]]]
    pn = rg.NestedRagged.from_nested_list(nested, device="cpu")
    jn = jrg.NestedRagged.from_nested_list(nested)
    assert pn.num_levels == jn.num_levels == 2
    same(pn.values, jn.values, True)
    for a, b in zip(pn.lengths, jn.lengths):
        same(a, b, True)
    same(pn.outer_segment_ids(), jn.outer_segment_ids(), True)
    for k in range(2):
        same(pn.level(k), jn.level(k))
    same(pn.flatten_outer().level(0), jn.flatten_outer().level(0))
    rs = np.random.RandomState(1)
    vals = rs.randn(6, 2).astype(np.float32)
    lens = ([2, 1], [3, 1, 2])
    pp = rg.NestedRagged.from_parts(vals, lens, device="cpu")
    jp = jrg.NestedRagged.from_parts(vals, lens)
    same(pp.outer_segment_ids(), jp.outer_segment_ids(), True)
    with pytest.raises(Exception, match="sum"):
        rg.NestedRagged.from_parts(vals, ([2, 2], [3, 1, 2]), device="cpu")
    with pytest.raises(Exception):
        pp.flatten_outer().flatten_outer()


@pytest.mark.parametrize("max_len,num", [(512, 8), (100, 3), (8, 4)])
def test_buckets_equal_jaxs(max_len, num):
    b = rg.bucket_boundaries(max_len, num)
    assert b == jrg.bucket_boundaries(max_len, num)
    for length in (1, 9, 64, 99, 700):
        assert rg.bucket_for(length, b) == jrg.bucket_for(length, b)


# -------------------------------------------------------------- sequence

POOLS = ("sum", "mean", "sqrt", "max", "min", "first", "last")


@pytest.mark.parametrize("pool", POOLS)
def test_sequence_pool_equals_jaxs_with_empty_rows(pool):
    rs = np.random.RandomState(2)
    # rows 1 and 4 are empty: max/min leave -inf/+inf there
    vals = rs.randn(9, 3).astype(np.float32)
    lens = np.array([3, 0, 4, 2, 0], np.int32)
    prb = rg.RaggedBatch(t(vals), t(lens))
    jrb = jrg.RaggedBatch(jnp.asarray(vals), jnp.asarray(lens))
    same(seq.sequence_pool(prb, pool), jseq.sequence_pool(jrb, pool))
    ints = (rs.randint(-5, 5, 9)).astype(np.int32)
    same(seq.sequence_pool(rg.RaggedBatch(t(ints), t(lens)), pool),
         jseq.sequence_pool(jrg.RaggedBatch(jnp.asarray(ints),
                                            jnp.asarray(lens)), pool))
    with pytest.raises(ValueError):
        seq.sequence_pool(prb, "median")


def test_sequence_pool_first_last_and_softmax_equal_jaxs():
    rs = np.random.RandomState(3)
    prb, jrb = pair(feats(rs, [2, 5, 1]))
    same(seq.sequence_first_step(prb), jseq.sequence_first_step(jrb))
    same(seq.sequence_last_step(prb), jseq.sequence_last_step(jrb))
    prb, jrb = pair([rs.randn(L).astype(np.float32) * 5 for L in (4, 1, 6)])
    same(seq.sequence_softmax(prb), jseq.sequence_softmax(jrb))


def test_sequence_mask_expand_reverse_pad_unpad_equal_jaxs():
    rs = np.random.RandomState(4)
    lens = np.array([1, 3, 0, 2], np.int32)
    for maxlen in (None, 5):
        same(seq.sequence_mask(t(lens), maxlen),
             jseq.sequence_mask(jnp.asarray(lens), maxlen))
    same(seq.sequence_mask(t(lens), 4, torch.int32),
         jseq.sequence_mask(jnp.asarray(lens), 4, jnp.int32))
    x = rs.randn(3, 2).astype(np.float32)
    py, jy = pair([[1, 1, 1], [2], [3, 3]])
    same(seq.sequence_expand(t(x), py), jseq.sequence_expand(jnp.asarray(x),
                                                             jy))
    same(seq.sequence_expand_as(t(x), py),
         jseq.sequence_expand_as(jnp.asarray(x), jy))
    prb, jrb = pair(feats(rs, [3, 1, 4]))
    same(seq.sequence_reverse(prb), jseq.sequence_reverse(jrb))
    for maxlen in (None, 6):
        same(seq.sequence_pad(prb, -1.0, maxlen),
             jseq.sequence_pad(jrb, -1.0, maxlen))
    dense, plens = seq.sequence_pad(prb, 0.0, 4)
    same(seq.sequence_unpad(dense, plens),
         jseq.sequence_unpad(jnp.asarray(n(dense)), jnp.asarray(n(plens))))


def test_sequence_concat_slice_enumerate_erase_scatter_equal_jaxs():
    rs = np.random.RandomState(5)
    a, ja = pair(feats(rs, [2, 0, 3]))
    b, jb = pair(feats(rs, [1, 2, 2]))
    same(seq.sequence_concat([a, b]), jseq.sequence_concat([ja, jb]))
    prb, jrb = pair(feats(rs, [4, 3, 5]))
    same(seq.sequence_slice(prb, 1, 2), jseq.sequence_slice(jrb, 1, 2))
    off, ln = np.array([0, 1, 2], np.int32), np.array([3, 1, 2], np.int32)
    same(seq.sequence_slice(prb, t(off), t(ln)),
         jseq.sequence_slice(jrb, jnp.asarray(off), jnp.asarray(ln)))
    ids = np.array([3, 1, 4, 1, 5], np.int32)
    for win, pad in ((2, 0), (3, -1)):
        same(seq.sequence_enumerate(t(ids), win, pad),
             jseq.sequence_enumerate(jnp.asarray(ids), win, pad))
    prb, jrb = pair([[1, 2, 3, 2], [2, 2], [4, 5]])
    same(seq.sequence_erase(prb, [2]), jseq.sequence_erase(jrb, [2]))
    x = rs.randn(2, 5).astype(np.float32)
    pid, jid = pair([[0, 2, 2], [1]])
    pup, jup = pair([[1.0, 2.0, 3.0], [4.0]])
    same(seq.sequence_scatter(t(x), pid, pup),
         jseq.sequence_scatter(jnp.asarray(x), jid, jup))


@pytest.mark.parametrize("start,length,bias,max_len",
                         [(-1, 3, False, None), (0, 2, True, None),
                          (-2, 4, True, 7)])
def test_sequence_conv_equals_jaxs(start, length, bias, max_len):
    rs = np.random.RandomState(6)
    D, O = 3, 4
    prb, jrb = pair(feats(rs, [4, 2, 5, 1], D))
    w = rs.randn(length * D, O).astype(np.float32)
    b = rs.randn(O).astype(np.float32) if bias else None
    same(seq.sequence_conv(prb, t(w), start, length,
                           t(b) if bias else None, max_len),
         jseq.sequence_conv(jrb, jnp.asarray(w), start, length,
                            jnp.asarray(b) if bias else None, max_len))


@pytest.mark.parametrize("k", [1, 3])
def test_row_conv_equals_jaxs(k):
    rs = np.random.RandomState(7)
    prb, jrb = pair(feats(rs, [5, 2, 3], 2))
    w = rs.randn(k, 2).astype(np.float32)
    same(seq.row_conv(prb, t(w)), jseq.row_conv(jrb, jnp.asarray(w)))


@pytest.mark.parametrize("kernels,strides,paddings",
                         [((2, 2), (2, 2), (0, 0, 0, 0)),
                          ((3, 2), (1, 2), (1, 0, 2, 1))])
def test_im2sequence_equals_jaxs(kernels, strides, paddings):
    x = np.random.RandomState(8).randn(2, 3, 5, 6).astype(np.float32)
    same(seq.im2sequence(t(x), kernels, strides, paddings),
         jseq.im2sequence(jnp.asarray(x), kernels, strides, paddings))


@pytest.mark.parametrize("d", [2, 3, 8, 9])
def test_add_position_encoding_equals_jaxs(d):
    x = np.random.RandomState(9).randn(2, 7, d).astype(np.float32)
    same(seq.add_position_encoding(t(x), 0.5, 2.0),
         jseq.add_position_encoding(jnp.asarray(x), 0.5, 2.0))


@pytest.mark.parametrize("merge", [True, False])
@pytest.mark.parametrize("with_lengths", [True, False])
def test_ctc_align_equals_jaxs(merge, with_lengths):
    rs = np.random.RandomState(10)
    tokens = rs.randint(0, 4, (4, 9)).astype(np.int32)
    tokens[0] = 0                             # all blank
    lens = np.array([9, 5, 0, 7], np.int32) if with_lengths else None
    got = seq.ctc_align(t(tokens), t(lens) if with_lengths else None,
                        merge_repeated=merge, padding_value=-1)
    want = jseq.ctc_align(jnp.asarray(tokens),
                          jnp.asarray(lens) if with_lengths else None,
                          merge_repeated=merge, padding_value=-1)
    same(got, want, True)
    assert got[1].dtype == torch.int32


# ------------------------------------------------------------ text_match

@pytest.mark.parametrize("act", [None, "tanh"])
def test_match_matrix_tensor_equals_jaxs(act):
    rs = np.random.RandomState(11)
    x = rs.randn(2, 4, 3).astype(np.float32)
    y = rs.randn(2, 5, 3).astype(np.float32)
    w = rs.randn(3, 2, 3).astype(np.float32)
    xl, yl = np.array([4, 2], np.int32), np.array([3, 5], np.int32)
    same(tm.match_matrix_tensor(t(x), t(y), t(w), t(xl), t(yl), act),
         jtm.match_matrix_tensor(jnp.asarray(x), jnp.asarray(y),
                                 jnp.asarray(w), jnp.asarray(xl),
                                 jnp.asarray(yl), act))


@pytest.mark.parametrize("stride,kernel", [(1, (3, 3)), (2, (3, 2)),
                                           ((1, 2), (2, 3))])
def test_var_conv_2d_equals_jaxs(stride, kernel):
    rs = np.random.RandomState(12)
    x = rs.randn(3, 2, 6, 7).astype(np.float32)
    w = rs.randn(4, 2, *kernel).astype(np.float32)
    rl, cl = np.array([6, 3, 0], np.int32), np.array([7, 2, 5], np.int32)
    same(tm.var_conv_2d(t(x), t(rl), t(cl), t(w), stride),
         jtm.var_conv_2d(jnp.asarray(x), jnp.asarray(rl), jnp.asarray(cl),
                         jnp.asarray(w), stride))


@pytest.mark.parametrize("topks", [(1, 3), (2, 5, 8)])
def test_sequence_topk_avg_pooling_and_gradient_equal_jaxs(topks):
    """Rounded values tie often (the lower column goes first in both);
    a sample with 2 valid columns still divides by each k."""
    rs = np.random.RandomState(13)
    x = np.round(rs.randn(3, 2, 4, 6), 1).astype(np.float32)
    rl, cl = np.array([4, 2, 3], np.int32), np.array([6, 2, 5], np.int32)

    def jf(a):
        return jtm.sequence_topk_avg_pooling(a, jnp.asarray(rl),
                                             jnp.asarray(cl), topks, 2)
    g = np.random.RandomState(14).randn(3, 4, 2 * len(topks)).astype(
        np.float32)
    want, vjp = jax.vjp(jf, jnp.asarray(x))
    xt = t(x).requires_grad_()
    got = tm.sequence_topk_avg_pooling(xt, t(rl), t(cl), topks, 2)
    got.backward(t(g))
    same(got, want)
    same(xt.grad, vjp(jnp.asarray(g))[0])


# ------------------------------------------------------------ nets, metrics

def test_nets_equal_jaxs():
    rs = np.random.RandomState(15)
    x = rs.randn(2, 6, 4).astype(np.float32)
    same(nets.glu(t(x)), jnets.glu(jnp.asarray(x)))
    same(nets.glu(t(x), axis=1), jnets.glu(jnp.asarray(x), axis=1))
    img = rs.randn(2, 3, 8, 8).astype(np.float32)
    w = rs.randn(4, 3, 3, 3).astype(np.float32)
    b = rs.randn(4).astype(np.float32)
    same(nets.simple_img_conv_pool(t(img), t(w), t(b), act="relu"),
         jnets.simple_img_conv_pool(jnp.asarray(img), jnp.asarray(w),
                                    jnp.asarray(b), act="relu"))
    hwio = np.transpose(w, (2, 3, 1, 0))
    nhwc = np.transpose(img, (0, 2, 3, 1))
    same(nets.simple_img_conv_pool(t(nhwc), t(hwio), pool_type="avg",
                                   data_format="NHWC"),
         jnets.simple_img_conv_pool(jnp.asarray(nhwc), jnp.asarray(hwio),
                                    pool_type="avg", data_format="NHWC"))
    ws = [w, rs.randn(5, 4, 3, 3).astype(np.float32)]
    bs = [b, rs.randn(5).astype(np.float32)]
    same(nets.img_conv_group(t(img), [t(a) for a in ws], [t(a) for a in bs]),
         jnets.img_conv_group(jnp.asarray(img),
                              [jnp.asarray(a) for a in ws],
                              [jnp.asarray(a) for a in bs]))
    prb, jrb = pair(feats(rs, [4, 1, 3]))
    f = rs.randn(9, 5).astype(np.float32)
    for pool in ("max", "sum"):
        same(nets.sequence_conv_pool(prb, t(f), pool_type=pool),
             jnets.sequence_conv_pool(jrb, jnp.asarray(f), pool_type=pool))


def test_metric_ops_equal_jaxs():
    rs = np.random.RandomState(16)
    logits = np.round(rs.randn(20, 5), 1).astype(np.float32)   # ties
    labels = rs.randint(0, 5, (20, 1)).astype(np.int32)
    for k in (1, 3):
        same(mo.accuracy(t(logits), t(labels), k),
             jmo.accuracy(jnp.asarray(logits), jnp.asarray(labels), k))
    probs = rs.rand(50, 2).astype(np.float32)
    bin_labels = rs.randint(0, 2, (50, 1)).astype(np.int32)
    for nt in (4096, 7):
        same(mo.auc(t(probs), t(bin_labels), nt),
             jmo.auc(jnp.asarray(probs), jnp.asarray(bin_labels), nt))
    same(mo.auc(t(probs[:, 1]), t(bin_labels[:, 0])),
         jmo.auc(jnp.asarray(probs[:, 1]), jnp.asarray(bin_labels[:, 0])))
    pred = rs.randint(0, 4, (30, 1)).astype(np.int32)
    lab = rs.randint(0, 4, (30,)).astype(np.int32)
    same(mo.precision_recall(t(pred), t(lab), 5),
         jmo.precision_recall(jnp.asarray(pred), jnp.asarray(lab), 5))


# ------------------------------------------------------- layers, bridge

@pytest.mark.parametrize("act", [None, "tanh"])
def test_sequence_conv_and_row_conv_layers_through_the_bridge(act):
    from paddle_tpu.nn.layers import RowConv as JRowConv
    from paddle_tpu.nn.layers import SequenceConv as JSequenceConv
    from paddle_tpu_torch.bridge import export_params, load_params
    from paddle_tpu_torch.nn import RowConv, SequenceConv
    rs = np.random.RandomState(17)
    prb, jrb = pair(feats(rs, [4, 2, 5], 3))
    for port, ref in ((SequenceConv(3, 4, 3, -1, act=act),
                       JSequenceConv(3, 4, 3, -1, act=act)),
                      (SequenceConv(3, 2, 2, 0, bias=False),
                       JSequenceConv(3, 2, 2, 0, bias=False)),
                      (RowConv(3, 2), JRowConv(3, 2))):
        v = ref.init(jax.random.key(0))
        load_params(port, jax.tree_util.tree_map(np.asarray, v["params"]))
        same(port(prb), ref.apply(v, jrb))
        same(port(prb, max_len=6), ref.apply(v, jrb, max_len=6))
        flat = export_params(port)
        same(port(prb), ref.apply({"params": flat, "state": {}}, jrb))


def _entry_points():
    from paddle_tpu_torch.models.sentiment import (SentimentConfig,
                                                   StackedLSTMSentiment,
                                                   TextCNNSentiment)
    from paddle_tpu_torch.models.tagging import BiLstmCrfTagger, TaggerConfig
    return {
        "RaggedBatch.from_list": lambda **kw: rg.RaggedBatch.from_list(
            [[1, 2], [3]], **kw),
        "NestedRagged.from_parts": lambda **kw: rg.NestedRagged.from_parts(
            np.zeros((3, 2)), ([2], [1, 2]), **kw),
        "NestedRagged.from_nested_list":
            lambda **kw: rg.NestedRagged.from_nested_list([[1, 2], [3]],
                                                          **kw),
        "TextCNNSentiment": lambda **kw: TextCNNSentiment(
            SentimentConfig.tiny(), **kw),
        "StackedLSTMSentiment": lambda **kw: StackedLSTMSentiment(
            SentimentConfig.tiny(), **kw),
        "BiLstmCrfTagger": lambda **kw: BiLstmCrfTagger(TaggerConfig.tiny(),
                                                        **kw),
    }


@pytest.mark.parametrize("entry", sorted(_entry_points()))
def test_entry_points_need_the_card_unless_asked_for_the_cpu(entry):
    from paddle_tpu_torch.core.enforce import EnforceError
    fn = _entry_points()[entry]
    assert fn(device="cpu") is not None
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(EnforceError, match="CUDA"):
        fn()
