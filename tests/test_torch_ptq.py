"""The port's QAT and PTQ (``paddle_tpu_torch/quant/qat.py``,
``quant/ptq.py``) against the JAX package's (``paddle_tpu/quant``), on
the same weights carried over by the bridge, on a small conv + fc net
(``tests/test_quant.py``'s ``_TinyNet``).

Tolerances: the quantized forward and its gradients 1e-5 (the f32 op
bar); activation scales 1e-6 (an abs-max and one moving-average step,
the same f32 arithmetic); int8 weights bit for bit and their scales
1e-6; the loaded int8 artifact's outputs 1e-5 of the JAX predictor's.
"""

import json
import os

import numpy as np
import pytest
import torch
from torch import nn

import jax
import jax.numpy as jnp

torch.set_num_threads(1)

OP_TOL = dict(rtol=1e-5, atol=1e-5)
SCALE_TOL = dict(rtol=1e-6, atol=1e-6)
CONFIGS = [
    dict(),
    dict(activation_quantize_type="range_abs_max", window_size=1),
    dict(weight_quantize_type="abs_max", activation_quantize_type="abs_max",
         weight_bits=4),
]


def _read_json(path):
    with open(path) as f:
        return json.load(f)


def _jax_net():
    from paddle_tpu.nn import layers as L
    from paddle_tpu.nn.module import Module

    class TinyNet(Module):
        def __init__(self):
            super().__init__()
            self.conv = L.Conv2D(1, 4, 3, padding=1)
            self.fc = L.Linear(4 * 8 * 8, 10)

        def forward(self, x):
            h = jax.nn.relu(self.conv(x))
            return self.fc(h.reshape(h.shape[0], -1))

    return TinyNet()


class _PortNet(nn.Module):
    def __init__(self):
        super().__init__()
        from paddle_tpu_torch import nn as pnn
        self.conv = pnn.Conv2D(1, 4, 3, padding=1)
        self.fc = pnn.Linear(4 * 8 * 8, 10)

    def forward(self, x):
        h = torch.relu(self.conv(x))
        return self.fc(h.reshape(h.shape[0], -1))


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)


def _setup(cfg_kw, seed=0):
    """(jax quantized net, its variables, port quantized net, port float
    twin, batches) on the same float weights."""
    from paddle_tpu import quant as JQ
    from paddle_tpu_torch import quant as PQ
    jf = _jax_net()
    fv = jf.init(jax.random.key(seed))
    jq = JQ.quantize_model(_jax_net(), JQ.QuantConfig(**cfg_kw))
    jv = JQ.upgrade_variables(jq, fv, jax.random.key(seed))
    params = jax.tree_util.tree_map(np.asarray, fv["params"])
    pq = PQ.quantize_model(_PortNet(), PQ.QuantConfig(**cfg_kw))
    PQ.upgrade_variables(pq, {"params": params, "state": {}})
    pf = _PortNet()
    from paddle_tpu_torch import bridge
    bridge.load_params(pf, params)
    rs = np.random.RandomState(seed)
    xs = [rs.randn(8, 1, 8, 8).astype(np.float32) * s for s in (1.0, 1.7)]
    return jq, jv, pq, pf, xs


@pytest.mark.parametrize("cfg_kw", CONFIGS)
def test_quantize_model_forward_and_gradient(cfg_kw):
    from paddle_tpu_torch import bridge
    from paddle_tpu_torch import quant as PQ
    jq, jv, pq, _, xs = _setup(cfg_kw)
    assert isinstance(pq.conv, PQ.QuantizedConv2D)
    assert isinstance(pq.fc, PQ.QuantizedLinear)
    x = xs[0]
    ct = np.random.RandomState(1).randn(8, 10).astype(np.float32)

    def loss_fn(params):
        res = jq.apply({"params": params, "state": jv["state"]},
                       jnp.asarray(x), training=True)
        # a net with no quantizer state returns the output alone
        out, st = res if isinstance(res, tuple) else (res, {})
        return jnp.sum(out * ct), (out, st)

    (_, (jout, jstate)), jgrad = jax.value_and_grad(
        loss_fn, has_aux=True)(jv["params"])
    pq.train()
    pout = pq(torch.from_numpy(x))
    (pout * torch.from_numpy(ct)).sum().backward()
    np.testing.assert_allclose(_np(pout), np.asarray(jout), **OP_TOL)
    for name, p in pq.named_parameters():
        want = bridge.flatten(jax.tree_util.tree_map(np.asarray, jgrad))
        np.testing.assert_allclose(_np(p.grad), want[name], **OP_TOL,
                                   err_msg=name)
    # the training forward moved the activation scales as the reference's
    got = bridge.flatten(bridge.export_state(pq))
    want = bridge.flatten(jax.tree_util.tree_map(np.asarray, jstate))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], **SCALE_TOL, err_msg=k)


@pytest.mark.parametrize("cfg_kw", CONFIGS)
def test_calibrate_freeze_and_export_int8(cfg_kw):
    from paddle_tpu import quant as JQ
    from paddle_tpu_torch import bridge
    from paddle_tpu_torch import quant as PQ
    jq, jv, pq, _, xs = _setup(cfg_kw)
    jv = JQ.calibrate(jq, jv, [jnp.asarray(x) for x in xs])
    PQ.calibrate(pq, [torch.from_numpy(x) for x in xs])
    assert pq.training                     # calibrate restores the mode
    pq.eval()
    got = bridge.flatten(bridge.export_state(pq))
    want = bridge.flatten(jax.tree_util.tree_map(np.asarray, jv["state"]))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], **SCALE_TOL, err_msg=k)
    jv = JQ.freeze(jq, jv)
    PQ.freeze(pq)
    want = bridge.flatten(jax.tree_util.tree_map(np.asarray, jv["params"]))
    for name, p in pq.named_parameters():
        np.testing.assert_allclose(_np(p), want[name], **SCALE_TOL,
                                   err_msg=name)
    # the frozen eval forward
    with torch.no_grad():
        np.testing.assert_allclose(
            _np(pq(torch.from_numpy(xs[0]))),
            np.asarray(jq.apply(jv, jnp.asarray(xs[0]))), **OP_TOL)
    jpay, ppay = JQ.export_int8(jq, jv), PQ.export_int8(pq)
    assert sorted(ppay) == sorted(jpay) == ["conv", "fc"]
    for name, je in jpay.items():
        pe = ppay[name]
        assert sorted(pe) == sorted(je)
        assert pe["weight_int8"].dtype == torch.int8
        np.testing.assert_array_equal(pe["weight_int8"].numpy(),
                                      np.asarray(je["weight_int8"]))
        for key in ("weight_scale", "bias", "act_scale"):
            if key in je:
                np.testing.assert_allclose(_np(pe[key]), np.asarray(je[key]),
                                           **SCALE_TOL)
        assert (pe["weight_bits"], pe["channel_axis"]) == \
            (je["weight_bits"], je["channel_axis"])
    # the int8 serving matmul on the fc's input
    h = np.random.RandomState(2).randn(3, 256).astype(np.float32)
    np.testing.assert_allclose(
        _np(PQ.int8_linear(torch.from_numpy(h), ppay["fc"])),
        np.asarray(JQ.int8_linear(jnp.asarray(h), jpay["fc"])), **OP_TOL)


def test_int8_artifact_against_the_jax_predictor(tmp_path):
    from paddle_tpu import quant as JQ
    from paddle_tpu.io.inference import load_inference_model as jload
    from paddle_tpu_torch import quant as PQ
    from paddle_tpu_torch.io.inference import load_inference_model, \
        read_params_bin
    jq, jv, pq, pf, xs = _setup({})
    jv = JQ.freeze(jq, JQ.calibrate(jq, jv, [jnp.asarray(x) for x in xs]))
    PQ.freeze(PQ.calibrate(pq, [torch.from_numpy(x) for x in xs]))
    x = xs[0]
    jpath, ppath = str(tmp_path / "jax"), str(tmp_path / "port")
    JQ.save_int8_inference_model(jpath, jq, jv, (jnp.asarray(x),),
                                 float_model=_jax_net())
    PQ.save_int8_inference_model(ppath, pq, (torch.from_numpy(x),),
                                 float_model=pf)
    got = load_inference_model(ppath, device="cpu")(torch.from_numpy(x))
    want = np.asarray(jload(jpath)(jnp.asarray(x)))
    np.testing.assert_allclose(_np(got), want, **OP_TOL)
    # the eager frozen model (the float twin over the frozen weights)
    pf.load_state_dict({k: v for k, v in pq.state_dict().items()
                        if "input_quant" not in k})
    with torch.no_grad():
        torch.testing.assert_close(got, pf(torch.from_numpy(x)), rtol=0,
                                   atol=0)
    sig = _read_json(os.path.join(ppath, "signature.json"))
    jsig = _read_json(os.path.join(jpath, "signature.json"))
    assert sig["treedef"] == jsig["treedef"]
    assert sig["num_params"] == jsig["num_params"]
    # the quantized weights ride in params.bin as int8, byte for byte
    leaves = read_params_bin(os.path.join(ppath, "params.bin"))
    jleaves = read_params_bin(os.path.join(jpath, "params.bin"))
    assert [a.dtype for a in leaves] == [a.dtype for a in jleaves]
    assert sum(a.dtype == np.int8 for a in leaves) == 2
    for a, b in zip(leaves, jleaves):
        if a.dtype == np.int8:
            np.testing.assert_array_equal(a, b)


def test_config_and_root_quantization():
    from paddle_tpu_torch import nn as pnn
    from paddle_tpu_torch import quant as PQ
    with pytest.raises(Exception):
        PQ.QuantConfig(weight_quantize_type="nope")
    qlin = PQ.quantize_model(pnn.Linear(4, 3), PQ.QuantConfig())
    assert isinstance(qlin, PQ.QuantizedLinear)
    before = qlin.weight.detach().clone()
    PQ.freeze(qlin)
    assert not torch.equal(before, qlin.weight)
    payload = PQ.export_int8(qlin)
    assert "" in payload and payload[""]["weight_int8"].dtype == torch.int8
