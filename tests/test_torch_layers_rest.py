"""The layers the port added last, against the JAX package's on the CPU:
FC, Conv2DTranspose, Conv3D, GroupNorm, RMSNorm, PRelu,
BilinearTensorProduct, SpectralNorm (its power-iteration state after a
training step, frozen in eval), GRUUnit, NCE and TreeConv, each through
the bridge (forward and the gradients of every parameter and input);
Linear's ``bias_init``, LayerNorm's ``scale=`` / ``shift=`` (alone and
with a residual) and Dropout's ``mode``; the four initializers the port
lacked; and the space-to-depth ResNet stem against the 7x7 stem."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu import initializer as JI
from paddle_tpu import nn as jnn
from paddle_tpu.models import resnet as jresnet
from paddle_tpu_torch import bridge
from paddle_tpu_torch import initializer as PI
from paddle_tpu_torch import nn as pnn
from paddle_tpu_torch.models import resnet as presnet

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)


def N(*shape, seed=0, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        name = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flat(v, name + "."))
        else:
            out[name] = np.asarray(v)
    return out


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def check_layer(jlayer, port, inputs, training=False, rngs=None,
                port_kw=None, seed=0):
    """``port`` loaded with ``jlayer``'s initial variables; the output,
    and the gradients of a fixed random weighting of it with respect to
    every parameter and float input, against JAX. Returns (JAX variables,
    JAX new state or None)."""
    variables = _np(jlayer.init(jax.random.key(seed)))
    bridge.load_params(port, variables["params"])
    if variables.get("state"):
        bridge.load_state(port, variables["state"])
    port.train(training)
    port.zero_grad(set_to_none=True)
    new_state = {}

    def jfn(params, *xs):
        nonlocal new_state
        res = jlayer.apply({"params": params, "state": variables["state"]},
                           *xs, training=training,
                           rngs=dict(rngs) if rngs else None)
        if training and isinstance(res, tuple) and len(res) == 2 \
                and isinstance(res[1], dict):
            res, state = res
            if not new_state:           # the concrete call's, not a trace's
                new_state = state
        return res

    jx = [jnp.asarray(x) for x in inputs]
    jout = jfn(variables["params"], *jx)
    out_w = np.random.RandomState(9).randn(*jout.shape).astype(np.float32)
    fidx = [i for i, x in enumerate(inputs) if x.dtype.kind == "f"]

    def scalar(params, *fx):
        xs = list(jx)
        for i, v in zip(fidx, fx):
            xs[i] = v
        return jnp.sum(jfn(params, *xs) * out_w)
    grads = jax.grad(scalar, argnums=tuple(range(1 + len(fidx))))(
        variables["params"], *[jx[i] for i in fidx])
    tx = [torch.from_numpy(np.array(x)) for x in inputs]
    for i in fidx:
        tx[i].requires_grad_(True)
    out = port(*tx, **(port_kw or {}))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), **TOL)
    (out * torch.from_numpy(out_w)).sum().backward()
    named = dict(port.named_parameters())
    flat = _flat(grads[0])
    assert sorted(named) == sorted(flat)
    for name, p in named.items():
        np.testing.assert_allclose(p.grad.numpy(), flat[name], err_msg=name,
                                   **GRAD_TOL)
    for i, g in zip(fidx, grads[1:]):
        np.testing.assert_allclose(tx[i].grad.numpy(), np.asarray(g),
                                   err_msg=f"input {i}", **GRAD_TOL)
    return variables, (_np(new_state) if new_state else None)


@pytest.mark.parametrize("name", [
    "FC", "Conv2DTranspose", "Conv3D", "GroupNorm", "RMSNorm", "PRelu.all",
    "PRelu.channel", "BilinearTensorProduct", "GRUUnit", "TreeConv"])
def test_layer_against_the_reference(name):
    from paddle_tpu.ops.graph import tree_patch_coefficients
    layers = {
        "FC": (jnn.FC(12, 5, num_flatten_dims=2, act="tanh"),
               pnn.FC(12, 5, num_flatten_dims=2, act="tanh"),
               [N(2, 3, 3, 4, seed=1)]),
        "Conv2DTranspose": (
            jnn.Conv2DTranspose(2, 4, 3, stride=2, padding=1,
                                output_padding=1, groups=2, act="relu"),
            pnn.Conv2DTranspose(2, 4, 3, stride=2, padding=1,
                                output_padding=1, groups=2, act="relu"),
            [N(2, 2, 3, 4, seed=2)]),
        "Conv3D": (jnn.Conv3D(2, 3, 2, padding=1, act="sigmoid"),
                   pnn.Conv3D(2, 3, 2, padding=1, act="sigmoid"),
                   [N(1, 2, 3, 4, 3, seed=3)]),
        "GroupNorm": (jnn.GroupNorm(4, groups=2), pnn.GroupNorm(4, groups=2),
                      [N(2, 4, 3, 3, seed=4)]),
        "RMSNorm": (jnn.RMSNorm(6), pnn.RMSNorm(6), [N(3, 6, seed=5)]),
        "PRelu.all": (jnn.PRelu(), pnn.PRelu(), [N(2, 3, 4, seed=6)]),
        "PRelu.channel": (jnn.PRelu("channel", 3), pnn.PRelu("channel", 3),
                          [N(2, 3, 4, seed=7)]),
        "BilinearTensorProduct": (jnn.BilinearTensorProduct(4, 5, 2),
                                  pnn.BilinearTensorProduct(4, 5, 2),
                                  [N(3, 4, seed=8), N(3, 5, seed=9)]),
        "GRUUnit": (jnn.GRUUnit(3, 4, origin_mode=True),
                    pnn.GRUUnit(3, 4, origin_mode=True),
                    [N(2, 3, seed=10), N(2, 4, seed=11)]),
        "TreeConv": (jnn.TreeConv(3, 2, 4, max_depth=2, act="tanh"),
                     pnn.TreeConv(3, 2, 4, max_depth=2, act="tanh"),
                     [N(2, 5, 3, seed=12), tree_patch_coefficients(
                         [[[1, 2], [1, 3], [3, 4], [3, 5]],
                          [[1, 2], [2, 3], [0, 0], [0, 0]]], 5, 2)]),
    }
    jl, pl, inputs = layers[name]
    variables, _ = check_layer(jl, pl, inputs)
    if name == "TreeConv":
        np.testing.assert_array_equal(pl.build_coef(
            [[[1, 2], [2, 3]]], 4), jl.build_coef([[[1, 2], [2, 3]]], 4))


def test_spectral_norm_state_after_a_step_and_frozen_in_eval():
    j = jnn.SpectralNorm((4, 3, 2), dim=1, power_iters=2)
    p = pnn.SpectralNorm((4, 3, 2), dim=1, power_iters=2)
    w = N(4, 3, 2, seed=13)
    variables, new_state = check_layer(j, p, [w], training=True)
    assert new_state is not None
    np.testing.assert_allclose(p.u.numpy(), new_state["u"], **TOL)
    np.testing.assert_allclose(p.v.numpy(), new_state["v"], **TOL)
    assert not np.allclose(new_state["u"], variables["state"]["u"])
    held = (p.u.clone(), p.v.clone())
    p.eval()
    out = p(torch.from_numpy(w))
    assert torch.equal(p.u, held[0]) and torch.equal(p.v, held[1])
    want = j.apply({"params": {}, "state": new_state}, jnp.asarray(w))
    np.testing.assert_allclose(out.numpy(), np.asarray(want), **TOL)


def test_nce_layer_on_the_references_draw():
    key = jax.random.key(14)
    j = jnn.NCE(4, 10, num_neg_samples=3)
    p = pnn.NCE(4, 10, num_neg_samples=3)
    x, label = N(6, 4, seed=15, scale=2.0), np.arange(6, dtype=np.int32)
    _, sub = jax.random.split(key)
    neg = torch.from_numpy(np.array(jax.random.randint(sub, (6, 3), 0, 10)))
    check_layer(j, p, [x, label], rngs={"nce": key},
                port_kw=dict(neg=neg))
    from paddle_tpu_torch.core.enforce import EnforceError
    with pytest.raises(EnforceError):
        p(torch.from_numpy(x), torch.from_numpy(label))
    drawn = p(torch.from_numpy(x), torch.from_numpy(label),
              generator=torch.Generator().manual_seed(0))
    assert drawn.shape == (6, 1) and torch.isfinite(drawn).all()


def test_linear_bias_init_and_layer_norm_switches():
    j = jnn.Linear(4, 3, bias_init=JI.constant(0.5), act="relu")
    p = pnn.Linear(4, 3, bias_init=PI.constant(0.5), act="relu")
    assert torch.equal(p.bias, torch.full((3,), 0.5))
    check_layer(j, p, [N(5, 4, seed=16)])
    x, r = N(3, 2, 5, seed=17), N(3, 2, 5, seed=18)
    for scale, shift in ((False, False), (True, False), (False, True)):
        jl = jnn.LayerNorm(5, scale=scale, shift=shift)
        pl = pnn.LayerNorm(5, scale=scale, shift=shift)
        assert (pl.scale is not None) == scale
        assert (pl.bias is not None) == shift
        check_layer(jl, pl, [x])
        check_layer(jl, pl, [x, r])
    jl, pl = jnn.LayerNorm((2, 5), scale=False), pnn.LayerNorm((2, 5),
                                                               scale=False)
    check_layer(jl, pl, [x, r])


def test_dropout_modes():
    x = np.ones((200, 100), np.float32)
    for mode in ("upscale_in_train", "downgrade_in_infer"):
        jd = jnn.Dropout(0.3, mode=mode)
        pd = pnn.Dropout(0.3, gen=torch.Generator().manual_seed(0),
                         mode=mode)
        pd.eval()
        np.testing.assert_allclose(
            pd(torch.from_numpy(x)).numpy(),
            np.asarray(jd.apply({"params": {}, "state": {}},
                                jnp.asarray(x))), **TOL)
        pd.train()
        out = pd(torch.from_numpy(x))
        kept = out != 0
        assert abs(float(kept.float().mean()) - 0.7) < 0.02
        scale = 1 / 0.7 if mode == "upscale_in_train" else 1.0
        torch.testing.assert_close(out[kept], torch.full_like(out[kept],
                                                              scale))
        jout = np.asarray(jd.apply({"params": {}, "state": {}},
                                   jnp.asarray(x), training=True,
                                   rngs={"dropout": jax.random.key(1)}))
        assert set(np.unique(jout)) == {0.0, np.float32(scale)}
    assert torch.equal(pnn.Dropout(0.0, mode="downgrade_in_infer")(
        torch.from_numpy(x)), torch.from_numpy(x))


def test_the_four_initializers():
    shape = (3, 3, 4, 4)
    for pi, ji in ((PI.ones(), JI.ones()), (PI.bilinear(), JI.bilinear()),
                   (PI.numpy_array(N(*shape, seed=19)),
                    JI.numpy_array(N(*shape, seed=19)))):
        np.testing.assert_array_equal(
            pi(shape, None).numpy(),
            np.asarray(ji(jax.random.key(0), shape)))
    assert PI.bilinear()((2, 3, 5, 3)).shape == (2, 3, 5, 3)
    with pytest.raises(AssertionError):
        PI.numpy_array(np.zeros(3))((4,))
    g = lambda s: torch.Generator().manual_seed(s)  # noqa: E731
    t = PI.truncated_normal(1.0, 2.0)((200, 300), g(0))
    assert float(t.min()) >= -3.0 and float(t.max()) <= 5.0
    assert abs(float(t.mean()) - 1.0) < 0.02
    assert abs(float(t.std()) - 2.0 * 0.8796) < 0.02
    jt = np.asarray(JI.truncated_normal(1.0, 2.0)(jax.random.key(0),
                                                   (200, 300)))
    assert abs(float(t.std()) - jt.std()) < 0.02
    assert torch.equal(t, PI.truncated_normal(1.0, 2.0)((200, 300), g(0)))
    assert not torch.equal(t, PI.truncated_normal(1.0, 2.0)((200, 300),
                                                            g(1)))


def test_space_to_depth_stem_gives_the_7x7_stems_logits():
    w = N(7, 7, 3, 8, seed=20)
    np.testing.assert_array_equal(
        presnet._stem_s2d_weights(torch.from_numpy(w)).numpy(),
        np.asarray(jresnet._stem_s2d_weights(jnp.asarray(w))))
    x = N(2, 6, 8, 3, seed=21)
    np.testing.assert_array_equal(
        presnet._space_to_depth_nhwc(torch.from_numpy(x)).numpy(),
        np.asarray(jresnet._space_to_depth_nhwc(jnp.asarray(x))))
    with pytest.raises(ValueError):
        presnet._space_to_depth_nhwc(torch.zeros(1, 5, 4, 3))
    assert presnet.configure()["resnet_s2d_stem"] is False
    model = presnet.resnet18(10, device="cpu", seed=3)
    model.eval()
    images = torch.from_numpy(N(2, 3, 32, 32, seed=22))
    try:
        want = model(images)
        presnet.configure(resnet_s2d_stem=True)
        got = model(images)
    finally:
        presnet.configure(resnet_s2d_stem=False)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    # gradients in eval mode: at 32 x 32 the last stage's batch norm sees
    # two values a channel in training, which amplifies rounding
    presnet.configure(resnet_s2d_stem=True)
    try:
        got = model(images)
        got.sum().backward()
        g_s2d = model.stem.conv.weight.grad.clone()
    finally:
        presnet.configure(resnet_s2d_stem=False)
    model.zero_grad()
    want = model(images)
    want.sum().backward()
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(g_s2d, model.stem.conv.weight.grad,
                               rtol=1e-4, atol=1e-4)
