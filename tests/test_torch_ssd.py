"""The port's SSD path against the JAX package's: ``nn/heads.py``'s
``MultiBoxHead``, ``metrics.py``'s ``DetectionMAP`` and
``examples/train_ssd.py``'s TinySSD end to end (``tools/torch_ssd.py``).

Weights are drawn by the port and carried to the JAX model by the bridge
(``bridge.export_params``). Tolerances: the head's outputs and priors
within 1e-5; DetectionMAP within 1e-6; TinySSD at base 64 (1,280 priors),
batch 2, two Momentum(0.01, 0.9) steps: each loss and every parameter
within 1e-4 relative (and 1e-4 absolute), then ``detection_output`` on
image 0: counts and labels exact, scores and boxes within 1e-4 from each
package's own outputs, and the port's ``detection_output`` of JAX's own
outputs equal to JAX's (count, labels and box indices exact, values
within 1e-5). The JAX training steps run once, in a module-scope
fixture, under one ``jax.jit``.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools"))

import torch_ssd  # noqa: E402

BASE = 64
BATCH = 2
STEPS = 2
LR, MU = 0.01, 0.9


def _jax_tree(tree):
    return jax.tree_util.tree_map(lambda a: jnp.array(np.array(a)), tree)


def _jax_tiny_ssd(base):
    """``examples/train_ssd.py:34``'s TinySSD, as the example defines it."""
    from paddle_tpu import nn

    class TinySSD(nn.Module):
        def __init__(self):
            super().__init__()
            self.backbone = nn.Sequential([
                nn.Conv2D(3, 16, 3, stride=2, padding=1, act="relu"),
                nn.Conv2D(16, 32, 3, stride=2, padding=1, act="relu"),
            ])
            self.extra = nn.Conv2D(32, 64, 3, stride=2, padding=1,
                                   act="relu")
            self.head = nn.MultiBoxHead(
                [32, 64], torch_ssd.NUM_CLASSES,
                per_map_cfg=[
                    {"min_sizes": [base * 0.2], "max_sizes": [base * 0.4],
                     "aspect_ratios": [2.0]},
                    {"min_sizes": [base * 0.4], "max_sizes": [base * 0.8],
                     "aspect_ratios": [2.0]},
                ],
                base_size=base)

        def forward(self, images):
            f1 = self.backbone(images)
            return self.head([f1, self.extra(f1)])
    return TinySSD()


@pytest.fixture(scope="module")
def ssd_runs():
    """Both packages' TinySSD at base 64 from the same weights, trained
    STEPS Momentum steps on the example's first batch (batch 2)."""
    import paddle_tpu as pt
    from paddle_tpu.ops import detection as JD
    from paddle_tpu_torch import bridge
    from paddle_tpu_torch.optimizer import Momentum
    pm = torch_ssd.TinySSD(BASE, device="cpu", seed=0)
    jm = _jax_tiny_ssd(BASE)
    params = _jax_tree(bridge.export_params(pm))
    data = torch_ssd.ssd_batch(np.random.RandomState(0), BATCH, BASE)
    jdata = [jnp.asarray(np.array(d)) for d in data]
    jopt = pt.optimizer.Momentum(LR, MU)
    ostate = jopt.init(params)

    def loss_fn(p, images, gt, labels):
        locs, confs, boxes, _ = jm.apply({"params": p, "state": {}}, images)
        per_img = jax.vmap(lambda lo, co, g, gl: JD.ssd_loss(
            lo, co, g, gl, boxes / BASE))
        return jnp.mean(per_img(locs, confs, gt, labels)), 0.0

    @jax.jit
    def step(p, s, *batch):
        loss, p, s, _ = jopt.minimize(loss_fn, p, s, *batch)
        return loss, p, s

    @jax.jit
    def outputs(p, images):
        locs, confs, boxes, vars_ = jm.apply({"params": p, "state": {}},
                                             images)
        return locs[0], jax.nn.softmax(confs[0], -1), boxes / BASE, vars_

    popt = Momentum(pm.parameters(), LR, MU)
    jl, pl = [], []
    for _ in range(STEPS):
        loss, params, ostate = step(params, ostate, *jdata)
        jl.append(float(loss))
        pl.append(float(popt.minimize(pm, torch_ssd.ssd_loss_fn, *data)))
    return dict(pm=pm, data=data, jl=jl, pl=pl,
                jparams=jax.tree_util.tree_map(np.asarray, params),
                jout=[np.array(o) for o in outputs(params, jdata[0])])


def test_tiny_ssd_parameter_names_are_the_references():
    from paddle_tpu_torch import bridge
    names = sorted(bridge.flatten(bridge.export_params(
        torch_ssd.TinySSD(BASE, device="cpu"))))
    assert names == sorted([
        "backbone.0.weight", "backbone.0.bias", "backbone.1.weight",
        "backbone.1.bias", "extra.weight", "extra.bias",
        "head.loc_convs.0.weight", "head.loc_convs.0.bias",
        "head.loc_convs.1.weight", "head.loc_convs.1.bias",
        "head.conf_convs.0.weight", "head.conf_convs.0.bias",
        "head.conf_convs.1.weight", "head.conf_convs.1.bias"])


def test_tiny_ssd_momentum_steps_match_jax(ssd_runs):
    """Two Momentum steps from bridged weights: each loss and every
    parameter after them within 1e-4; the loss falls, as the example
    checks."""
    from paddle_tpu_torch import bridge
    np.testing.assert_allclose(ssd_runs["pl"], ssd_runs["jl"], rtol=1e-4,
                               atol=1e-4)
    assert ssd_runs["pl"][-1] < ssd_runs["pl"][0]
    want = bridge.flatten(ssd_runs["jparams"])
    got = bridge.flatten(bridge.export_params(ssd_runs["pm"]))
    assert sorted(got) == sorted(want)
    for k, v in got.items():
        np.testing.assert_allclose(v, want[k], rtol=1e-4, atol=1e-4,
                                   err_msg=k)


def test_tiny_ssd_detection_output_matches_jax(ssd_runs):
    """``detection_output`` on image 0 after training (score 0.01, NMS
    0.45, keep 10): from each package's own model, counts and labels
    exact and scores and boxes within 1e-4; from JAX's outputs, the
    port's call equal to JAX's (indices exact, values within 1e-5)."""
    from paddle_tpu.ops import detection as JD
    from paddle_tpu_torch.ops import detection as PD
    kw = dict(score_threshold=0.01, nms_threshold=0.45, keep_top_k=10)
    locs, scores, boxes, vars_ = ssd_runs["jout"]
    assert boxes.shape == (1280, 4)
    jout, jcount = jax.jit(lambda *a: JD.detection_output(*a, **kw))(
        locs, scores, boxes, vars_)
    pout, pcount = torch_ssd.detect(ssd_runs["pm"], ssd_runs["data"][0])
    assert int(pcount) == int(jcount) > 0
    np.testing.assert_array_equal(pout[:, 0].numpy(), np.asarray(jout)[:, 0])
    np.testing.assert_allclose(pout.numpy(), np.asarray(jout), rtol=1e-4,
                               atol=1e-4)
    out, count = PD.detection_output(*(torch.from_numpy(np.array(a))
                                       for a in (locs, scores, boxes, vars_)),
                                     **kw)
    assert int(count) == int(jcount)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=1e-5,
                               atol=1e-5)
    # the source rows (multiclass_nms2) of the decoded boxes
    dec = PD.box_coder(torch.from_numpy(boxes), torch.from_numpy(vars_),
                       torch.from_numpy(locs)[:, None, :],
                       "decode_center_size", axis=1).reshape(-1, 4)
    jdec = JD.box_coder(jnp.asarray(boxes), jnp.asarray(vars_),
                        jnp.asarray(locs)[:, None, :], "decode_center_size",
                        axis=1).reshape(-1, 4)
    nms_kw = dict(score_threshold=0.01, nms_threshold=0.45, keep_top_k=10,
                  background_label=0)
    _, idx, _ = PD.multiclass_nms2(dec, torch.from_numpy(scores.T.copy()),
                                   **nms_kw)
    _, jidx, _ = jax.jit(lambda d, s: JD.multiclass_nms2(d, s, **nms_kw))(
        jdec, jnp.asarray(scores.T))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))


def test_multibox_head_matches_jax():
    """``tests/test_distributions_heads.py:71``'s head (base 300, maps 10
    x 10 and 5 x 5, 4 and 6 priors a cell), with and without steps: locs,
    confs, priors and variances within 1e-5 of the JAX head's from the
    same weights."""
    from paddle_tpu import nn as jnn
    from paddle_tpu_torch import bridge
    from paddle_tpu_torch.nn import MultiBoxHead
    cfgs = [{"min_sizes": [60.0], "max_sizes": [110.0],
             "aspect_ratios": [2.0]},
            {"min_sizes": [110.0], "max_sizes": [160.0],
             "aspect_ratios": [2.0, 3.0]}]
    rng = np.random.RandomState(0)
    f1 = rng.randn(2, 8, 10, 10).astype(np.float32)
    f2 = rng.randn(2, 16, 5, 5).astype(np.float32)
    for kw in ({}, dict(steps=[30, (64.0, 50.0)], clip=True,
                        min_max_aspect_ratios_order=True)):
        ph = MultiBoxHead([8, 16], 4, cfgs, 300,
                          gen=torch.Generator().manual_seed(1), **kw)
        jh = jnn.MultiBoxHead([8, 16], num_classes=4, per_map_cfg=cfgs,
                              base_size=300, **kw)
        got = ph([torch.from_numpy(f1), torch.from_numpy(f2)])
        want = jh.apply({"params": _jax_tree(bridge.export_params(ph)),
                         "state": {}}, [jnp.asarray(f1), jnp.asarray(f2)])
        n = 10 * 10 * 4 + 5 * 5 * 6
        assert got[0].shape == (2, n, 4) and got[1].shape == (2, n, 4)
        assert got[2].shape == (n, 4) and got[3].shape == (n, 4)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                       rtol=1e-5, atol=1e-5)
        # the priors are built once a shape and device, then reused
        assert ph([torch.from_numpy(f1), torch.from_numpy(f2)])[2] is got[2]


DMAP_CASES = [
    (dict(class_num=3), [([[1, 0.9, 0, 0, 10, 10], [2, 0.8, 20, 20, 30, 30]],
                          [1, 2], [[0, 0, 10, 10], [20, 20, 30, 30]])]),
    (dict(class_num=2, ap_version="integral"),
     [([[1, 0.9, 0, 0, 10, 10], [1, 0.8, 50, 50, 60, 60]], [1, 1],
       [[0, 0, 10, 10], [100, 100, 110, 110]])]),
    (dict(class_num=2, ap_version="11point"),
     [([[1, 0.9, 0, 0, 10, 10], [1, 0.8, 50, 50, 60, 60]], [1, 1],
       [[0, 0, 10, 10], [100, 100, 110, 110]])]),
    (dict(class_num=2), [([[1, 0.9, 0, 0, 10, 10], [1, 0.85, 1, 1, 10, 10]],
                          [1], [[0, 0, 10, 10]])]),
    (dict(class_num=2, ap_version="11point"),
     [([[1, 0.9, 0, 0, 10, 10], [1, 0.85, 1, 1, 10, 10]], [1],
       [[0, 0, 10, 10]])]),
    (dict(class_num=3), [([[1, 0.9, 0, 0, 10, 10]], [1, 2],
                          [[0, 0, 10, 10], [50, 50, 60, 60]])]),
    (dict(class_num=3), [([[2, 0.9, 0, 0, 10, 10]], [2, -1, -1],
                          [[0, 0, 10, 10], [0, 0, 1, 1], [0, 0, 1, 1]])]),
    (dict(class_num=2, overlap_threshold=0.5),
     [([[1, 0.9, 0, 0, 10, 10]], [1], [[0, 0, 10, 20]])]),
]


@pytest.mark.parametrize("case", range(len(DMAP_CASES)))
def test_detection_map_matches_jax(case):
    """``tests/test_ops_misc.py:554-610``'s four cases (perfect, mixed in
    both AP versions, a duplicate detection, the reference's edge rules)
    against the JAX metric within 1e-6."""
    from paddle_tpu.metrics import DetectionMAP as JMap
    from paddle_tpu_torch.metrics import DetectionMAP as PMap
    kw, updates = DMAP_CASES[case]
    jm, pm = JMap(**kw), PMap(**kw)
    for det, gl, gb in updates:
        jm.update(det, gl, gb)
        pm.update(torch.tensor(det), torch.tensor(gl), torch.tensor(gb))
    assert abs(pm.eval() - jm.eval()) <= 1e-6


@pytest.mark.parametrize("ap_version", ["integral", "11point"])
def test_detection_map_random_batches_match_jax(ap_version):
    """Several images of random detections (scores with ties) and ground
    truth with difficult boxes, evaluated with and without them."""
    from paddle_tpu.metrics import DetectionMAP as JMap
    from paddle_tpu_torch.metrics import DetectionMAP as PMap
    rng = np.random.RandomState(3)
    for difficult in (True, False):
        kw = dict(class_num=4, ap_version=ap_version,
                  evaluate_difficult=difficult)
        jm, pm = JMap(**kw), PMap(**kw)
        for _ in range(4):
            gt = rng.uniform(0, 50, (5, 2))
            gb = np.concatenate([gt, gt + rng.uniform(5, 30, (5, 2))], 1)
            gl = rng.randint(0, 4, 5)
            diff = rng.rand(5) < 0.3
            jit = gb[rng.randint(0, 5, 8)] + rng.randn(8, 4) * 3
            det = np.concatenate([rng.randint(1, 4, (8, 1)),
                                  np.round(rng.rand(8, 1), 1), jit], 1)
            jm.update(det, gl, gb, diff)
            pm.update(torch.from_numpy(det), torch.from_numpy(gl),
                      torch.from_numpy(gb), torch.from_numpy(diff))
        assert abs(pm.eval() - jm.eval()) <= 1e-6
