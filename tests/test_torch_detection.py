"""The port's detection ops (``paddle_tpu_torch/ops/detection.py``,
``ops/mask.py``, the detection ops of ``ops/vision.py``, ``ops/loss.py
smooth_l1_loss``) against the JAX package's on the same numpy inputs.

Each case of ``tests/test_ops_detection.py`` and the detection cases of
``tests/test_ops_vision.py`` runs both functions. Tolerances: f32 outputs
within 1e-5 (rtol and atol); indices, labels, masks and counts exact
(compared by value: the port's integers are int64, the reference's
int32). Added: tie cases (duplicate boxes, equal scores, ``-inf``
padding in ``multiclass_nms``'s flat scores, equal mining losses), where
``lax.top_k``'s and ``jnp.argsort``'s order (the lower index first) must
be reproduced, and ``ssd_loss``'s gradients against ``jax.grad`` with
zero-padded ground-truth rows. The subsampling ops take the reference's
threefry draws through ``test_uniforms``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops import detection as _JD
from paddle_tpu.ops import loss as _JL
from paddle_tpu.ops import mask as JM
from paddle_tpu.ops import vision as _JV
from paddle_tpu_torch.ops import detection as PD
from paddle_tpu_torch.ops import loss as PL
from paddle_tpu_torch.ops import mask as PM
from paddle_tpu_torch.ops import vision as PV

TOL = 1e-5


def _is_array(a):
    leaves = jax.tree_util.tree_leaves(a)
    return bool(leaves) and all(isinstance(v, (jax.Array, np.ndarray))
                                for v in leaves)


class _Jitted:
    """A JAX module whose functions run under one ``jax.jit`` a call (the
    array arguments traced, the rest static): one compile a call costs a
    fraction of the op-by-op dispatch's many."""

    def __init__(self, module):
        self._module = module

    def __getattr__(self, name):
        fn = getattr(self._module, name)

        def call(*args, **kw):
            dyn = [i for i, a in enumerate(args) if _is_array(a)]
            kdyn = [k for k, a in kw.items() if _is_array(a)]

            def inner(d, kd):
                full = list(args)
                for i, v in zip(dyn, d):
                    full[i] = v
                return fn(*full, **{**kw, **kd})
            return jax.jit(inner)([args[i] for i in dyn],
                                  {k: kw[k] for k in kdyn})
        return call


JD, JL, JV = _Jitted(_JD), _Jitted(_JL), _Jitted(_JV)


def t(a):
    return torch.from_numpy(np.array(a))


def close(got, want, tol=TOL):
    np.testing.assert_allclose(_n(got), _n(want), rtol=tol, atol=tol)


def exact(got, want):
    np.testing.assert_array_equal(_n(got), _n(want))


def _n(x):
    if isinstance(x, torch.Tensor):
        return x.detach().numpy()
    return np.asarray(x)


def rand_boxes(rng, n, lo=0.0, hi=10.0):
    x1 = rng.uniform(lo, hi - 1, (n, 1))
    y1 = rng.uniform(lo, hi - 1, (n, 1))
    x2 = x1 + rng.uniform(0.5, hi - 1, (n, 1))
    y2 = y1 + rng.uniform(0.5, hi - 1, (n, 1))
    return np.concatenate([x1, y1, x2, y2], -1).astype(np.float32)


# ------------------------------------------------------------ geometry

@pytest.mark.parametrize("normalized", [True, False])
def test_iou_similarity(normalized):
    rng = np.random.RandomState(0 if normalized else 1)
    a, b = rand_boxes(rng, 5), rand_boxes(rng, 7)
    want = JD.iou_similarity(jnp.asarray(a), jnp.asarray(b), normalized)
    close(PD.iou_similarity(t(a), t(b), normalized), want)


def test_iou_similarity_batched_and_degenerate():
    """A leading batch dimension equals the reference per image; empty
    (zero) boxes give 0, not NaN."""
    rng = np.random.RandomState(2)
    a = rand_boxes(rng, 6).reshape(2, 3, 4)
    a[1, 2] = 0.0
    b = rand_boxes(rng, 5)
    got = PD.iou_similarity(t(a), t(b))
    for i in range(2):
        close(got[i], JD.iou_similarity(jnp.asarray(a[i]), jnp.asarray(b)))


@pytest.mark.parametrize("var", ["none", "vec", "per_prior"])
def test_box_coder_encode_decode(var):
    rng = np.random.RandomState(2)
    priors, targets = rand_boxes(rng, 6), rand_boxes(rng, 6)
    v = {"none": None,
         "vec": np.array([0.1, 0.1, 0.2, 0.2], np.float32),
         "per_prior": rng.uniform(0.1, 0.3, (6, 4)).astype(np.float32)}[var]
    jv = None if v is None else jnp.asarray(v)
    pv = None if v is None else t(v)
    for normalized in (True, False):
        enc = JD.box_coder(jnp.asarray(priors), jv, jnp.asarray(targets),
                           "encode_center_size", normalized)
        got = PD.box_coder(t(priors), pv, t(targets), "encode_center_size",
                           normalized)
        close(got, enc)
        for axis in (0, 1):
            for clip in (None, 0.5):
                want = JD.box_coder(jnp.asarray(priors), jv, enc,
                                    "decode_center_size", normalized, axis,
                                    clip)
                got = PD.box_coder(t(priors), pv, t(enc),
                                   "decode_center_size", normalized, axis,
                                   clip)
                close(got, want)
    # the reference's round trip: each target against its own prior
    enc = PD.box_coder(t(priors), pv, t(targets), "encode_center_size")
    diag = torch.stack([enc[i, i] for i in range(6)])
    dec = PD.box_coder(t(priors), pv, diag, "decode_center_size", axis=1)
    close(torch.stack([dec[i, i] for i in range(6)]), targets, 1e-4)


def test_box_clip():
    boxes = np.array([[-5.0, -5.0, 20.0, 30.0], [1, 2, 3, 4]], np.float32)
    want = JD.box_clip(jnp.asarray(boxes), (10.0, 15.0))
    got = PD.box_clip(t(boxes), (10.0, 15.0))
    close(got, want)
    exact(got[0], [0, 0, 14, 9])


@pytest.mark.parametrize("kw", [
    dict(min_sizes=[8.0], max_sizes=[16.0], aspect_ratios=[2.0], flip=True,
         clip=True),
    dict(min_sizes=[8.0, 12.0], max_sizes=[16.0, 20.0],
         aspect_ratios=[2.0, 3.0], flip=True,
         min_max_aspect_ratios_order=True, steps=(8.0, 6.0), offset=0.3),
    dict(min_sizes=[5.0], aspect_ratios=[1.0, 2.0, 2.0]),
])
def test_prior_box(kw):
    boxes, var = PD.prior_box((4, 5), (32, 40), device="cpu", **kw)
    jb, jv = JD.prior_box((4, 5), (32, 40), **kw)
    close(boxes, jb)
    close(var, jv)
    if kw.get("clip"):
        assert float(boxes.min()) >= 0.0 and float(boxes.max()) <= 1.0


def test_density_prior_box_and_anchor_generator():
    got = PD.density_prior_box((2, 3), (16, 24), fixed_sizes=[4.0, 8.0],
                               fixed_ratios=[1.0, 2.0], densities=[2, 1],
                               clip=True, device="cpu")
    want = JD.density_prior_box((2, 3), (16, 24), fixed_sizes=[4.0, 8.0],
                                fixed_ratios=[1.0, 2.0], densities=[2, 1],
                                clip=True)
    for g, w in zip(got, want):
        close(g, w)
    got = PD.anchor_generator((3, 4), anchor_sizes=[32.0, 64.0],
                              aspect_ratios=[0.5, 1.0, 2.0],
                              stride=(16.0, 16.0), device="cpu")
    want = JD.anchor_generator((3, 4), anchor_sizes=[32.0, 64.0],
                               aspect_ratios=[0.5, 1.0, 2.0],
                               stride=(16.0, 16.0))
    for g, w in zip(got, want):
        close(g, w)
    close(got[0][0, 0, 2], [-8.0, -8.0, 23.0, 23.0])   # ar 1, size 32


def test_priors_default_to_the_card():
    """Built from nothing, priors go to the card unless the CPU is asked
    for: without one, the call raises."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    from paddle_tpu_torch.core.enforce import EnforceError
    with pytest.raises(EnforceError):
        PD.prior_box((2, 2), (8, 8), [4.0])


# ------------------------------------------------------------ NMS

def np_greedy_nms(boxes, scores, thr):
    order = np.argsort(-scores, kind="stable")
    keep, sup = [], np.zeros(len(scores), bool)
    iou = np.asarray(JD.iou_similarity(jnp.asarray(boxes),
                                       jnp.asarray(boxes)))
    for oi, i in enumerate(order):
        if sup[oi]:
            continue
        keep.append(i)
        for oj in range(oi + 1, len(order)):
            if iou[i, order[oj]] > thr:
                sup[oj] = True
    return keep


@pytest.mark.parametrize("keep_top_k,score_threshold",
                         [(-1, -np.inf), (3, -np.inf), (8, 0.4)])
def test_nms(keep_top_k, score_threshold):
    rng = np.random.RandomState(3 + keep_top_k)
    boxes = rand_boxes(rng, 20)
    scores = rng.rand(20).astype(np.float32)
    jidx, jvalid = JD.nms(jnp.asarray(boxes), jnp.asarray(scores), 0.5,
                          score_threshold, keep_top_k)
    idx, valid = PD.nms(t(boxes), t(scores), 0.5, score_threshold,
                        keep_top_k)
    exact(idx, jidx)
    exact(valid, jvalid)
    if score_threshold == -np.inf:
        got = [int(i) for i, v in zip(idx, valid) if v]
        ref = np_greedy_nms(boxes, scores, 0.5)
        assert got == ref[:len(got)] and len(got) == min(
            len(ref), keep_top_k if keep_top_k > 0 else 20)


def test_nms_ties_duplicates_and_equal_scores():
    """Duplicate boxes and equal scores: the lower index is the kept one
    (stable sort), as in the reference."""
    boxes = np.array([[0, 0, 10, 10], [0, 0, 10, 10], [20, 20, 30, 30],
                      [20, 20, 30, 30], [0, 0, 10, 10], [40, 40, 41, 41]],
                     np.float32)
    scores = np.array([0.5, 0.5, 0.7, 0.7, 0.5, 0.5], np.float32)
    jidx, jvalid = JD.nms(jnp.asarray(boxes), jnp.asarray(scores), 0.3)
    idx, valid = PD.nms(t(boxes), t(scores), 0.3)
    exact(idx, jidx)
    exact(valid, jvalid)
    assert [int(i) for i, v in zip(idx, valid) if v] == [2, 0, 5]


@pytest.mark.parametrize("shared,background,nms_top_k,keep_top_k", [
    (True, 0, 400, 10), (False, -1, 12, 50), (True, -1, -1, -1)])
def test_multiclass_nms(shared, background, nms_top_k, keep_top_k):
    rng = np.random.RandomState(5)
    n, c = 30, 4
    boxes = (rand_boxes(rng, n) if shared
             else rand_boxes(rng, n * c).reshape(n, c, 4))
    scores = rng.rand(c, n).astype(np.float32)
    kw = dict(score_threshold=0.3, nms_top_k=nms_top_k,
              keep_top_k=keep_top_k, nms_threshold=0.4,
              background_label=background, return_index=True)
    jout, jidx, jcount = JD.multiclass_nms(jnp.asarray(boxes),
                                           jnp.asarray(scores), **kw)
    out, idx, count = PD.multiclass_nms(t(boxes), t(scores), **kw)
    assert int(count) == int(jcount)
    close(out, jout)
    exact(idx, jidx)
    cnt = int(count)
    assert (out[cnt:] == -1).all()
    assert (np.diff(_n(out[:cnt, 1])) <= 1e-6).all()


def test_multiclass_nms_ties_and_inf_padding():
    """Scores tied within and across classes, duplicate boxes, and more
    slots than survivors (the flat scores' -inf entries tie): the rows,
    their order and the indices are the reference's."""
    boxes = np.array([[0, 0, 10, 10], [0, 0, 10, 10], [20, 20, 30, 30],
                      [40, 40, 50, 50], [40, 40, 50, 50]], np.float32)
    scores = np.array([[0.6, 0.6, 0.6, 0.2, 0.6],
                       [0.6, 0.9, 0.6, 0.6, 0.6],
                       [0.6, 0.6, 0.1, 0.6, 0.6]], np.float32)
    kw = dict(score_threshold=0.3, nms_top_k=4, keep_top_k=12,
              nms_threshold=0.5, background_label=-1)
    jout, jidx, jcount = JD.multiclass_nms2(jnp.asarray(boxes),
                                            jnp.asarray(scores), **kw)
    out, idx, count = PD.multiclass_nms2(t(boxes), t(scores), **kw)
    assert int(count) == int(jcount) and int(count) < 12
    close(out, jout)
    exact(idx, jidx)


def test_detection_output_pipeline():
    priors = np.array([[0, 0, 10, 10], [20, 20, 30, 30]], np.float32)
    var = np.array([0.1, 0.1, 0.2, 0.2], np.float32)
    loc = np.zeros((2, 4), np.float32)
    scores = np.array([[0.1, 0.9], [0.2, 0.8]], np.float32)
    jout, jcount = JD.detection_output(jnp.asarray(loc), jnp.asarray(scores),
                                       jnp.asarray(priors), jnp.asarray(var),
                                       keep_top_k=5)
    out, count = PD.detection_output(t(loc), t(scores), t(priors), t(var),
                                     keep_top_k=5)
    assert int(count) == int(jcount) == 2
    close(out, jout)


def test_detection_output_random():
    rng = np.random.RandomState(12)
    n, c = 200, 5
    priors = rand_boxes(rng, n, 0, 1.0) / 10.0
    loc = (rng.randn(n, 4) * 0.2).astype(np.float32)
    logits = rng.randn(n, c).astype(np.float32)
    scores = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    var = np.tile(np.array([0.1, 0.1, 0.2, 0.2], np.float32), (n, 1))
    kw = dict(nms_threshold=0.45, nms_top_k=50, keep_top_k=20,
              score_threshold=0.01)
    jout, jcount = JD.detection_output(*map(jnp.asarray, (loc, scores,
                                                          priors, var)), **kw)
    out, count = PD.detection_output(t(loc), t(scores), t(priors), t(var),
                                     **kw)
    assert int(count) == int(jcount)
    close(out, jout)


@pytest.mark.parametrize("scores,kept", [
    ([[0.9, 0.05, 0.8]], {0, 2}), ([[0.5, 0.9]], {1})])
def test_multiclass_nms2_indices(scores, kept):
    boxes = np.array([[0, 0, 10, 10], [20, 20, 30, 30], [40, 40, 50, 50]],
                     np.float32)
    if len(scores[0]) == 2:     # duplicate boxes: the higher score's index
        boxes = np.array([[0, 0, 10, 10], [0, 0, 10, 10]], np.float32)
    scores = np.array(scores, np.float32)
    jout, jidx, jcount = JD.multiclass_nms2(jnp.asarray(boxes),
                                            jnp.asarray(scores),
                                            score_threshold=0.1,
                                            keep_top_k=4)
    out, idx, count = PD.multiclass_nms2(t(boxes), t(scores),
                                         score_threshold=0.1, keep_top_k=4)
    exact(idx, jidx)
    close(out, jout)
    assert int(count) == int(jcount) == len(kept)
    assert set(_n(idx)[:len(kept)].tolist()) == kept


# ------------------------------------------------------------ RoI ops

@pytest.mark.parametrize("sampling,aligned,scale", [
    (2, False, 1.0), (-1, True, 0.5), (3, False, 0.25)])
def test_roi_align(sampling, aligned, scale):
    rng = np.random.RandomState(7)
    x = rng.rand(2, 3, 8, 8).astype(np.float32)
    rois = np.array([[0, 0, 7, 7], [2, 2, 6, 5], [1, 0, 5, 7],
                     [-3, -2, 30, 40]], np.float32)
    bidx = np.array([0, 1, 0, 1], np.int32)
    want = JD.roi_align(jnp.asarray(x), jnp.asarray(rois), jnp.asarray(bidx),
                        2, 3, scale, sampling, aligned)
    got = PD.roi_align(t(x), t(rois), t(bidx), 2, 3, scale, sampling,
                       aligned)
    close(got, want)


def test_roi_pool():
    rng = np.random.RandomState(8)
    x = rng.rand(2, 2, 6, 7).astype(np.float32)
    rois = np.array([[0, 0, 3, 3], [1, 2, 6, 5], [4, 4, 4, 4],
                     [0, 0, 12, 10]], np.float32)
    bidx = np.array([0, 1, 1, 0], np.int32)
    want = JD.roi_pool(jnp.asarray(x), jnp.asarray(rois), jnp.asarray(bidx),
                       2, 3, 0.5)
    close(PD.roi_pool(t(x), t(rois), t(bidx), 2, 3, 0.5), want)
    x = np.arange(16, dtype=np.float32).reshape(1, 1, 4, 4)
    got = PD.roi_pool(t(x), t(np.array([[0, 0, 3, 3]], np.float32)),
                      t(np.array([0])), 2, 2, 1.0)
    exact(got[0, 0], [[5, 7], [13, 15]])


ROI_QUADS = [
    (np.random.RandomState(0).rand(1, 2, 6, 8), [[0, 0, 7, 0, 7, 5, 0, 5]],
     [0], 6, 8),
    (np.ones((1, 1, 4, 4)), [[2, 2, 9, 2, 9, 9, 2, 9]], [0], 4, 4),
    (np.stack([np.zeros((1, 4, 4)), np.ones((1, 4, 4))]),
     [[0, 0, 3, 0, 3, 3, 0, 3]], [1], 4, 4),
    (np.ones((1, 1, 16, 16)), [[0, 0, 3, 0, 3, 15, 0, 15]], [0], 16, 16),
    (np.random.RandomState(1).rand(2, 3, 9, 7),
     [[1, 1, 5, 2, 6, 7, 0, 6], [0.5, 0, 6, 1, 6, 8, 1, 7]], [1, 0], 5, 6),
]


@pytest.mark.parametrize("case", range(len(ROI_QUADS)))
def test_roi_perspective_transform(case):
    x, rois, bidx, th, tw = ROI_QUADS[case]
    x = np.asarray(x, np.float32)
    rois = np.asarray(rois, np.float32)
    bidx = np.asarray(bidx, np.int32)
    jout, jmask = JD.roi_perspective_transform(
        jnp.asarray(x), jnp.asarray(rois), jnp.asarray(bidx), th, tw)
    out, mask = PD.roi_perspective_transform(t(x), t(rois), t(bidx), th, tw)
    close(out, jout, 1e-4)
    exact(mask, jmask)
    if case == 0:
        close(out[0], x[0], 1e-4)


# ------------------------------------------------------------ YOLO

def test_yolo_box():
    rng = np.random.RandomState(8)
    b, na, cls, h, w = 2, 2, 3, 4, 4
    x = rng.randn(b, na * (5 + cls), h, w).astype(np.float32)
    img_size = np.array([[128, 128], [96, 64]], np.int32)
    for kw in (dict(conf_thresh=0.0), dict(conf_thresh=0.5, scale_x_y=1.2,
                                           clip_bbox=False)):
        jb, js = JD.yolo_box(jnp.asarray(x), jnp.asarray(img_size),
                             anchors=[10, 13, 16, 30], class_num=cls,
                             downsample_ratio=32, **kw)
        pb, ps = PD.yolo_box(t(x), t(img_size), anchors=[10, 13, 16, 30],
                             class_num=cls, downsample_ratio=32, **kw)
        close(pb, jb, 1e-4)
        close(ps, js)


@pytest.mark.parametrize("smooth", [False, True])
def test_yolov3_loss_and_gradient(smooth):
    rng = np.random.RandomState(9)
    b, cls, h, w = 2, 3, 4, 4
    x = rng.randn(b, 3 * (5 + cls), h, w).astype(np.float32)
    gt = np.zeros((b, 5, 4), np.float32)
    gt[:, 0] = [0.5, 0.5, 0.3, 0.4]
    gt[:, 1] = [0.2, 0.3, 0.1, 0.2]
    gt[1, 2] = [0.8, 0.1, 0.6, 0.5]
    lbl = np.array([[0, 2, 0, 0, 0], [1, 0, 2, 0, 0]], np.int32)
    kw = dict(anchors=[10, 13, 16, 30, 33, 23, 30, 61, 62, 45, 59, 119],
              anchor_mask=[0, 1, 2], class_num=cls, downsample_ratio=32,
              ignore_thresh=0.5, use_label_smooth=smooth)
    jloss, jgrad = jax.jit(jax.value_and_grad(lambda v: _JD.yolov3_loss(
        v, jnp.asarray(gt), jnp.asarray(lbl), **kw).sum()))(jnp.asarray(x))
    xt = t(x).requires_grad_()
    loss = PD.yolov3_loss(xt, t(gt), t(lbl), **kw)
    loss.sum().backward()
    close(loss.sum(), jloss, 1e-4)
    close(loss, JD.yolov3_loss(jnp.asarray(x), jnp.asarray(gt),
                               jnp.asarray(lbl), **kw), 1e-4)
    close(xt.grad, jgrad, 1e-4)


# ------------------------------------------------------------ proposals

def test_generate_proposals():
    rng = np.random.RandomState(10)
    a = 50
    anchors = rand_boxes(rng, a, 0, 60)
    scores = rng.rand(a).astype(np.float32)
    scores[7] = scores[3]                           # a tie in the top-k
    deltas = (rng.randn(a, 4) * 0.1).astype(np.float32)
    var = np.ones((a, 4), np.float32)
    for kw in (dict(pre_nms_top_n=30, post_nms_top_n=10, nms_thresh=0.7),
               dict(pre_nms_top_n=50, post_nms_top_n=60, nms_thresh=0.3,
                    min_size=8.0)):
        want = JD.generate_proposals(
            jnp.asarray(scores), jnp.asarray(deltas), jnp.asarray(anchors),
            jnp.asarray(var), (64.0, 64.0), **kw)
        got = PD.generate_proposals(t(scores), t(deltas), t(anchors), t(var),
                                    (64.0, 64.0), **kw)
        close(got[0], want[0])
        np.testing.assert_allclose(_n(got[1]), np.asarray(want[1]),
                                   rtol=TOL, atol=TOL, equal_nan=True)
        exact(got[2], want[2])


def test_distribute_fpn_proposals():
    rois = np.array([[0, 0, 10, 10], [0, 0, 224, 224], [0, 0, 1000, 1000],
                     [5, 5, 120, 90]], np.float32)
    jl, jm = JD.distribute_fpn_proposals(jnp.asarray(rois), 2, 5, 4, 224)
    pl, pm = PD.distribute_fpn_proposals(t(rois), 2, 5, 4, 224)
    exact(pl, jl)
    exact(pm, jm)


def test_box_decoder_and_assign():
    rng = np.random.RandomState(13)
    prior = rand_boxes(rng, 5, 0, 40)
    var = np.array([0.1, 0.1, 0.2, 0.2], np.float32)
    tb = (rng.randn(5, 12) * 0.5).astype(np.float32)
    tb[0, 6] = 40.0                                 # past bbox_clip
    score = rng.rand(5, 3).astype(np.float32)
    score[1, 1] = score[1, 2]                       # a tie: the first wins
    jd, ja = JD.box_decoder_and_assign(*map(jnp.asarray,
                                            (prior, var, tb, score)))
    pd_, pa = PD.box_decoder_and_assign(t(prior), t(var), t(tb), t(score))
    close(pd_, jd, 1e-4)
    close(pa, ja, 1e-4)


# ------------------------------------------------------------ matching

@pytest.mark.parametrize("match_type", ["bipartite", "per_prediction"])
def test_bipartite_match(match_type):
    for dist in ([[0.9, 0.1, 0.3], [0.8, 0.7, 0.2]],
                 [[0.9, 0.1, 0.6], [0.8, 0.7, 0.2]],
                 [[0.5, 0.5, 0.6, 0.6], [0.5, 0.6, 0.6, 0.0],
                  [-1.0, -1.0, -1.0, -1.0]]):       # ties and a dead row
        d = np.array(dist, np.float32)
        jm, jd = JD.bipartite_match(jnp.asarray(d), match_type, 0.5)
        pm, pd_ = PD.bipartite_match(t(d), match_type, 0.5)
        exact(pm, jm)
        close(pd_, jd)


def test_bipartite_match_batched():
    """A leading batch dimension equals the reference image by image."""
    rng = np.random.RandomState(14)
    d = rng.rand(3, 4, 9).astype(np.float32)
    d[1, 2] = -1.0
    d[2] = np.round(d[2], 1)                        # many ties
    pm, pd_ = PD.bipartite_match(t(d), "per_prediction", 0.4)
    for i in range(3):
        jm, jd = JD.bipartite_match(jnp.asarray(d[i]), "per_prediction", 0.4)
        exact(pm[i], jm)
        close(pd_[i], jd)


def test_target_assign():
    x = np.array([[1.0, 2.0], [3.0, 4.0]], np.float32)
    mi = np.array([1, -1, 0], np.int32)
    jo, jw = JD.target_assign(jnp.asarray(x), jnp.asarray(mi), -9.0)
    po, pw = PD.target_assign(t(x), t(mi), -9.0)
    close(po, jo)
    close(pw, jw)


@pytest.mark.parametrize("case", ["reference", "equal_losses", "batched"])
def test_mine_hard_examples(case):
    if case == "reference":
        loss = np.array([[0.9, 0.1, 0.8, 0.2, 0.5]], np.float32)
        match = np.array([[0, -1, -1, -1, -1]], np.int32)
    elif case == "equal_losses":    # the cut falls inside a run of ties
        loss = np.array([[0.5, 0.7, 0.5, 0.5, 0.7, 0.5, 0.5, 0.1]],
                        np.float32)
        match = np.array([[-1, 0, -1, -1, -1, -1, -1, -1]], np.int32)
    else:
        rng = np.random.RandomState(15)
        loss = np.round(rng.rand(3, 30), 1).astype(np.float32)
        match = np.where(rng.rand(3, 30) < 0.2, 0, -1).astype(np.int32)
        match[2] = -1                               # no positive: min_neg
    got = PD.mine_hard_examples(t(loss), t(match), 3.0)
    for i in range(loss.shape[0]):
        exact(got[i], JD.mine_hard_examples(jnp.asarray(loss[i]),
                                            jnp.asarray(match[i]), 3.0))
    if case == "reference":
        assert np.where(_n(got[0]))[0].tolist() == [2, 3, 4]


def test_smooth_l1_loss():
    rng = np.random.RandomState(16)
    x = (rng.randn(6, 4) * 2).astype(np.float32)
    y = (rng.randn(6, 4) * 2).astype(np.float32)
    for sigma in (1.0, 3.0):
        close(PL.smooth_l1_loss(t(x), t(y), sigma),
              JL.smooth_l1_loss(jnp.asarray(x), jnp.asarray(y), sigma))
        close(PL.smooth_l1_loss(t(x[0]), t(y[0]), sigma),
              JL.smooth_l1_loss(jnp.asarray(x[0]), jnp.asarray(y[0]), sigma))


def _ssd_inputs(rng, b=2, m=12, c=4, g=3):
    priors = rand_boxes(rng, m, 0, 1.0) / 10.0
    loc = (rng.randn(b, m, 4) * 0.1).astype(np.float32)
    conf = rng.randn(b, m, c).astype(np.float32)
    gt = np.zeros((b, g, 4), np.float32)
    gt[0, 0] = priors[2] + 0.01
    gt[0, 1] = priors[7] - 0.01
    gt[1, 0] = priors[5]
    lbl = np.array([[1, 2, 0], [3, 0, 0]], np.int32)
    return priors, loc, conf, gt, lbl


def test_ssd_loss_and_gradients_match_jax_grad():
    """ssd_loss over a batch (zero-padded gt rows in both images; image 1
    also with every row padded) and its gradients w.r.t. location and
    confidence against jax.grad of the reference vmapped over images:
    finite, within 1e-5."""
    rng = np.random.RandomState(11)
    priors, loc, conf, gt, lbl = _ssd_inputs(rng)
    gt = np.concatenate([gt, np.zeros((1, 3, 4), np.float32)])
    loc = np.concatenate([loc, loc[:1] * 0.5])
    conf = np.concatenate([conf, conf[:1]])
    lbl = np.concatenate([lbl, lbl[:1]])
    jp = jnp.asarray(priors)

    def jloss(lo, co):
        return jax.vmap(lambda a, b_, g, gl: _JD.ssd_loss(a, b_, g, gl, jp))(
            lo, co, jnp.asarray(gt), jnp.asarray(lbl))
    (_, want), (gl_, gc_) = jax.jit(jax.value_and_grad(
        lambda lo, co: (jloss(lo, co).sum(), jloss(lo, co)), (0, 1),
        has_aux=True))(jnp.asarray(loc), jnp.asarray(conf))
    lt, ct = t(loc).requires_grad_(), t(conf).requires_grad_()
    got = PD.ssd_loss(lt, ct, t(gt), t(lbl), t(priors))
    got.sum().backward()
    close(got, want)
    assert torch.isfinite(lt.grad).all() and torch.isfinite(ct.grad).all()
    close(lt.grad, gl_)
    close(ct.grad, gc_)
    # one image without the batch dimension is the reference's call
    close(PD.ssd_loss(t(loc[0]), t(conf[0]), t(gt[0]), t(lbl[0]),
                      t(priors)), want[0])


def test_ssd_loss_equal_mining_losses():
    """Every negative with the same loss (identical confidences): hard
    mining picks the lower indices first, as the reference's stable
    argsort does."""
    rng = np.random.RandomState(17)
    priors, loc, conf, gt, lbl = _ssd_inputs(rng)
    conf[:] = 0.25
    want = jax.jit(jax.vmap(lambda a, b_, g, gl: _JD.ssd_loss(
        a, b_, g, gl, jnp.asarray(priors))))(*map(jnp.asarray,
                                                  (loc, conf, gt, lbl)))
    close(PD.ssd_loss(t(loc), t(conf), t(gt), t(lbl), t(priors)), want)


# ------------------------------------------------------------ targets

def _draws(key, n):
    r1, r2 = jax.random.split(key)
    return (np.array(jax.random.uniform(r1, (n,))),
            np.array(jax.random.uniform(r2, (n,))))


RPN_CASES = [
    ([[0, 0, 10, 10], [100, 100, 110, 110], [0, 0, 7, 10],
      [200, 200, 204, 204]], [[0, 0, 10, 10], [199, 199, 210, 210]], None,
     dict(rpn_batch_size_per_im=8, rpn_fg_fraction=0.5), 0),
    (np.tile([[0, 0, 10, 10]], (100, 1)), [[0, 0, 10, 10]], None,
     dict(rpn_batch_size_per_im=32, rpn_fg_fraction=0.25), 1),
    ([[0, 0, 4, 4], [50, 50, 60, 60]], [[50, 50, 60, 60], [0, 0, 0, 0]],
     [True, False], dict(rpn_batch_size_per_im=2,
                         rpn_negative_overlap=0.3), 2),
    ([[0, 0, 4, 4], [9, 9, 12, 12]], np.zeros((2, 4)), [False, False],
     dict(rpn_batch_size_per_im=2), 1),
    (np.concatenate([np.tile([[0, 0, 10, 10]], (20, 1)),
                     rand_boxes(np.random.RandomState(3), 40, 0, 60)]),
     [[0, 0, 10, 10], [30, 30, 50, 45]], None,
     dict(rpn_batch_size_per_im=16, rpn_fg_fraction=0.25), 4),
]


@pytest.mark.parametrize("case", range(len(RPN_CASES)))
def test_rpn_target_assign(case):
    anchors, gts, valid, kw, seed = RPN_CASES[case]
    anchors = np.asarray(anchors, np.float32)
    gts = np.asarray(gts, np.float32)
    jvalid = None if valid is None else jnp.asarray(valid)
    key = jax.random.key(seed)
    jl, jt = JD.rpn_target_assign(key, jnp.asarray(anchors),
                                  jnp.asarray(gts), jvalid, **kw)
    pl, pt = PD.rpn_target_assign(
        None, t(anchors), t(gts), None if valid is None else t(valid),
        test_uniforms=_draws(key, len(anchors)), **kw)
    exact(pl, jl)
    close(pt, jt)


def test_rpn_target_assign_from_a_generator():
    """With a torch.Generator the draws are torch's: the caps hold and a
    generator's seed repeats the labels."""
    anchors = t(np.tile([[0, 0, 10, 10]], (100, 1)).astype(np.float32))
    gts = t(np.array([[0, 0, 10, 10]], np.float32))
    runs = [PD.rpn_target_assign(torch.Generator().manual_seed(5), anchors,
                                 gts, rpn_batch_size_per_im=32,
                                 rpn_fg_fraction=0.25)[0] for _ in range(2)]
    exact(runs[0], runs[1])
    assert int((runs[0] == 1).sum()) == 8 and int((runs[0] == -1).sum()) == 92


PROPOSAL_CASES = [
    ([[0, 0, 10, 10], [0, 0, 5, 10], [40, 40, 50, 50]], [3],
     [[0, 0, 10, 10]], None, dict(batch_size_per_im=4, fg_fraction=0.5,
                                  class_num=5), 0),
    (np.tile([[0, 0, 10, 10]], (50, 1)), [2], [[0, 0, 10, 10]], None,
     dict(batch_size_per_im=16, fg_fraction=0.25, class_num=4), 1),
    ([[0, 0, 10, 10]], [1], [[2, 2, 12, 12]], None,
     dict(batch_size_per_im=2, class_num=2), 0),
    ([[0, 0, 4, 4], [8, 8, 12, 12]], [1], np.zeros((1, 4)), [False],
     dict(batch_size_per_im=2, class_num=3), 0),
    (rand_boxes(np.random.RandomState(4), 60, 0, 40), [1, 3, 2],
     [[0, 0, 10, 10], [20, 20, 35, 30], [5, 15, 25, 38]], [True, True, True],
     dict(batch_size_per_im=24, fg_fraction=0.25, class_num=4,
          bbox_reg_weights=(1.0, 1.0, 1.0, 1.0)), 6),
]


@pytest.mark.parametrize("case", range(len(PROPOSAL_CASES)))
def test_generate_proposal_labels(case):
    rois, cls, gts, valid, kw, seed = PROPOSAL_CASES[case]
    rois = np.asarray(rois, np.float32)
    gts = np.asarray(gts, np.float32)
    cls = np.asarray(cls, np.int32)
    key = jax.random.key(seed)
    want = JD.generate_proposal_labels(
        key, jnp.asarray(rois), jnp.asarray(cls), jnp.asarray(gts),
        None if valid is None else jnp.asarray(valid), **kw)
    got = PD.generate_proposal_labels(
        None, t(rois), t(cls), t(gts), None if valid is None else t(valid),
        test_uniforms=_draws(key, len(rois)), **kw)
    exact(got[0], want[0])
    close(got[1], want[1])
    exact(got[2], want[2])
    exact(got[3], want[3])


def test_retinanet_target_assign():
    rng = np.random.RandomState(18)
    anchors = np.concatenate([
        np.array([[0, 0, 10, 10], [100, 100, 110, 110], [0, 0, 9, 10]],
                 np.float32), rand_boxes(rng, 30, 0, 50)])
    gts = np.array([[0, 0, 10, 10], [20, 20, 40, 35], [0, 0, 0, 0]],
                   np.float32)
    labels = np.array([7, 2, 5], np.int32)
    for valid in (None, [True, True, False]):
        want = JD.retinanet_target_assign(
            jnp.asarray(anchors), jnp.asarray(gts), jnp.asarray(labels),
            None if valid is None else jnp.asarray(valid))
        got = PD.retinanet_target_assign(
            t(anchors), t(gts), t(labels),
            None if valid is None else t(np.array(valid)))
        exact(got[0], want[0])
        close(got[1], want[1])
        exact(got[2], want[2])


# ------------------------------------------------------------ masks

def test_poly2mask_and_polys_to_mask_wrt_box():
    for poly, h, w in (([2, 1, 6, 1, 6, 5, 2, 5], 8, 8),
                       ([0.5, 0.2, 7.3, 2.1, 4.4, 6.9, 1.2, 5.5, 0.3, 3.0],
                        9, 8)):
        exact(PM.poly2mask(poly, h, w), JM.poly2mask(poly, h, w))
    box = [10, 10, 30, 30]
    parts = [[10, 10, 20, 10, 20, 30, 10, 30], [22, 22, 29, 23, 25, 29]]
    for res in (8, 14):
        exact(PM.polys_to_mask_wrt_box(parts, box, res),
              JM.polys_to_mask_wrt_box(parts, box, res))


def test_generate_mask_labels():
    rois = [[0, 0, 10, 10], [20, 20, 30, 30], [2, 1, 9, 12],
            [100, 100, 110, 110]]
    labels = [3, 0, 1, 3]
    gt_boxes = [[0, 0, 10, 10], [1, 1, 11, 12]]
    gt_polys = [[[0, 0, 10, 0, 10, 10, 0, 10]],
                [[1, 1, 11, 1, 6, 12], [2, 2, 4, 2, 3, 5]]]
    want = JM.generate_mask_labels(rois, labels, gt_boxes, gt_polys, 6)
    got = PM.generate_mask_labels(t(np.array(rois, np.float32)),
                                  t(np.array(labels)), gt_boxes, gt_polys, 6)
    exact(got, want)
    exact(got[0], np.ones((6, 6)))
    exact(got[3], -np.ones((6, 6)))


# ------------------------------------------------------------ vision

def test_polygon_box_transform():
    x = np.random.RandomState(19).rand(2, 4, 3, 5).astype(np.float32)
    close(PV.polygon_box_transform(t(x)),
          JV.polygon_box_transform(jnp.asarray(x)))


def test_psroi_pool():
    rng = np.random.RandomState(20)
    oc, ph, pw = 2, 2, 3
    x = rng.rand(2, oc * ph * pw, 9, 8).astype(np.float32)
    rois = np.array([[0, 0, 7, 7], [1.4, 2.6, 6.2, 8.1], [3, 3, 3, 3]],
                    np.float32)
    bidx = np.array([0, 1, 1], np.int32)
    for scale in (1.0, 0.5):
        want = JV.psroi_pool(jnp.asarray(x), jnp.asarray(rois),
                             jnp.asarray(bidx), oc, ph, pw, scale)
        close(PV.psroi_pool(t(x), t(rois), t(bidx), oc, ph, pw, scale), want)
    # the reference's uniform case: each bin reads its own channel
    u = np.zeros((1, 8, 8, 8), np.float32)
    u[0] = np.arange(8)[:, None, None]
    got = PV.psroi_pool(t(u), t(np.array([[0.0, 0, 7, 7]], np.float32)),
                        t(np.array([0])), 2, 2, 2)
    exact(got[0].reshape(-1), np.arange(8))


def test_prroi_pool():
    rng = np.random.RandomState(21)
    x = rng.rand(2, 3, 7, 9).astype(np.float32)
    rois = np.array([[0.3, 0.2, 6.1, 5.5], [2.5, 1.0, 8.7, 6.9],
                     [-2.0, -1.0, 3.0, 2.0], [4.0, 4.0, 4.0, 6.0]],
                    np.float32)
    bidx = np.array([0, 1, 1, 0], np.int32)
    want = JV.prroi_pool(jnp.asarray(x), jnp.asarray(rois), jnp.asarray(bidx),
                         2, 3, 0.8)
    close(PV.prroi_pool(t(x), t(rois), t(bidx), 2, 3, 0.8), want)


@pytest.mark.parametrize("with_trans", [False, True])
def test_deformable_psroi_pool(with_trans):
    rng = np.random.RandomState(22)
    out_dim, gh, gw, ph, pw = 4, 2, 2, 2, 3
    x = rng.rand(2, out_dim * gh * gw, 10, 9).astype(np.float32)
    rois = np.array([[0, 0, 7, 7], [2.4, 1.2, 8.6, 9.3], [5, 5, 6, 6]],
                    np.float32)
    bidx = np.array([0, 1, 0], np.int32)
    trans = (rng.randn(3, 4, 2, 3) if with_trans else None)
    kw = dict(output_dim=out_dim, group_size=(gh, gw), pooled_height=ph,
              pooled_width=pw, part_size=(2, 3), sample_per_part=2,
              spatial_scale=0.75, trans_std=0.2)
    want = JV.deformable_psroi_pool(
        jnp.asarray(x), jnp.asarray(rois), jnp.asarray(bidx),
        None if trans is None else jnp.asarray(trans, jnp.float32), **kw)
    got = PV.deformable_psroi_pool(
        t(x), t(rois), t(bidx),
        None if trans is None else t(trans.astype(np.float32)), **kw)
    close(got[0], want[0])
    close(got[1], want[1])


def test_collect_fpn_proposals_with_ties():
    r1 = np.array([[0.0, 0, 1, 1], [1, 1, 2, 2], [5, 5, 6, 6]], np.float32)
    r2 = np.array([[3.0, 3, 4, 4], [7, 7, 8, 8]], np.float32)
    s1 = np.array([0.9, 0.5, 0.1], np.float32)
    s2 = np.array([0.5, 0.9], np.float32)
    for k in (2, 4, 9):
        jr, js = JV.collect_fpn_proposals(
            [jnp.asarray(r1), jnp.asarray(r2)],
            [jnp.asarray(s1), jnp.asarray(s2)], k)
        pr, ps = PV.collect_fpn_proposals([t(r1), t(r2)], [t(s1), t(s2)], k)
        close(pr, jr)
        close(ps, js)


def test_sigmoid_focal_loss_and_gradient():
    rng = np.random.RandomState(23)
    logits = (rng.randn(6, 3) * 3).astype(np.float32)
    labels = np.array([0, 1, 2, 3, 1, 0], np.int32)
    want, jg = jax.jit(jax.value_and_grad(lambda v: _JV.sigmoid_focal_loss(
        v, jnp.asarray(labels), 2.0).sum()))(jnp.asarray(logits))
    lt = t(logits).requires_grad_()
    got = PV.sigmoid_focal_loss(lt, t(labels), 2.0)
    got.sum().backward()
    close(got, JV.sigmoid_focal_loss(jnp.asarray(logits),
                                     jnp.asarray(labels), 2.0))
    close(lt.grad, jg)


def test_retinanet_detection_output():
    rng = np.random.RandomState(24)
    levels = []
    for n in (40, 12):
        anchors = rand_boxes(rng, n, 0, 60)
        deltas = (rng.randn(n, 4) * 0.1).astype(np.float32)
        scores = rng.rand(n, 3).astype(np.float32)
        levels.append((deltas, scores, anchors))
    levels[1][1][3] = levels[1][1][5]                # tied best scores
    im = (64.0, 60.0)
    kw = dict(score_threshold=0.2, nms_top_k=10, keep_top_k=15,
              nms_threshold=0.4)
    jout, jcount = JV.retinanet_detection_output(
        *[[jnp.asarray(lv[i]) for lv in levels] for i in range(3)], im, **kw)
    out, count = PV.retinanet_detection_output(
        *[[t(lv[i]) for lv in levels] for i in range(3)], im, **kw)
    assert int(count) == int(jcount)
    close(out, jout, 1e-4)
