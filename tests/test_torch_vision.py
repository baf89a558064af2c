"""The PyTorch port's image classifiers against the JAX reference, on the
CPU: the conv, pool and batch-norm ops, relu's gradient at 0, ResNet,
VGG, SE-ResNeXt and the MNIST models, Momentum training in f32 and under
the bf16 policy, and the bridge of params and BN state.

The same inputs, made with numpy from a seed, go through the JAX function
and its counterpart in the port; the weights and running statistics are
the same on both sides (drawn by the port, bridged). No Pallas kernel
lies on this path.

Tolerances: 1e-5 for the f32 ops (sums in another order); logits and
updated running statistics within 1e-4 of the larger of 1 and the JAX
values' largest magnitude. One case is held at 1e-3: ResNet-50 at 64 x 64
in training mode. Its batch norms reduce over as few as 8 values a
channel (2 x 2 x 2 in the last stage) and the one-pass variance
E[x^2] - E[x]^2 cancels, so on the CPU the reference's own logits move
by 1.0e-4 when its input moves by one f32 ulp; the two packages sum the f32
statistics in other orders (at the stem the port's are within 5e-6 of the
exact statistics, the reference's within 2.3e-5), and the logits differ
by 3.8e-4.

Training: three Momentum(0.01, 0.9) steps of ResNet-18 on centered
images (a normalized input pipeline's): loss, parameters and running
statistics within 1e-4. Centered, because on bench.py's uncentered images
the reference's own f32 gradients lie 3e-2 from the exact ones (its sums
cancel at the stem), which the last test shows; and lr 0.01, because at
0.1 four images swing the loss from 2.3 to 0.8 and back in three steps
and the two trajectories part by more than rounding. Under the bf16
policy: the loss within bf16's 2^-7 relative; every running statistic of
the port exactly a bf16 value (updated in bf16, stored back in f32) and
within 2^-5 of its leaf's largest JAX value. The jitted reference keeps
some of those updates in f32 (XLA drops the f32 -> bf16 -> f32 round
trip), so its statistics are not all bf16 values; with each of three
steps free to round an update the other way, they differ by up to 1.9
bf16 ulps (0.0145 of a leaf's largest value).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
BF16_REL = 2.0 ** -7
BF16_STATS_REL = 2.0 ** -5
LR = 0.01


def t(a):
    return torch.from_numpy(np.array(np.asarray(a)))


def n(x):
    return x.detach().float().numpy()


def _np(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


@pytest.fixture
def rng():
    return np.random.RandomState(0)


# ------------------------------------------------------------------ ops

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_relu_gradient_at_zero_is_the_references(dtype):
    """jnp.maximum(x, 0) splits its gradient at x == 0: 0.5 there (the
    port's relu gave torch.relu's 0)."""
    from paddle_tpu.ops.activations import relu as jrelu
    from paddle_tpu_torch.ops.activations import relu
    x = np.array([0.0, 1.0, -1.0, 0.0, 2.5], np.float32)
    want = jax.grad(lambda v: jrelu(v).astype(jnp.float32).sum())(
        jnp.asarray(x).astype(dtype))
    xt = t(x).to(getattr(torch, dtype)).requires_grad_(True)
    relu(xt).float().sum().backward()
    np.testing.assert_array_equal(n(xt.grad), np.asarray(want, np.float32))
    assert n(xt.grad)[0] == 0.5


# layout, padding, stride, dilation, groups ("C": depthwise), bias
CONV_CASES = [
    ("NCHW", 1, 1, 1, 1, True),
    ("NHWC", 1, 1, 1, 1, False),
    ("NCHW", (1, 2), 1, 1, 1, False),
    ("NHWC", ((0, 1), (2, 1)), 1, 1, 1, True),
    ("NCHW", "SAME", 2, 1, 1, False),
    ("NHWC", "SAME", 2, 1, 1, True),
    ("NCHW", "VALID", 1, 1, 1, True),
    ("NHWC", "valid", 2, 1, 1, False),
    ("NCHW", 2, 1, 2, 1, False),
    ("NHWC", "SAME", 1, 2, 1, False),
    ("NCHW", 1, 1, 1, 4, True),
    ("NHWC", 1, 2, 1, 4, False),
    ("NCHW", 1, 1, 1, "C", False),
    ("NHWC", "SAME", 2, 1, "C", True),
]


@pytest.mark.parametrize("layout,padding,stride,dilation,groups,bias",
                         CONV_CASES)
def test_conv2d_matches_jax(rng, layout, padding, stride, dilation, groups,
                            bias):
    """conv2d values and the gradients of x, the weight and the bias, in
    both of the reference's layouts (NCHW/OIHW, NHWC/HWIO)."""
    from paddle_tpu.ops import nn as JF
    from paddle_tpu_torch.ops import nn as PF
    c, o = 8, 16
    g = c if groups == "C" else groups
    x = rng.randn(2, c, 9, 10).astype(np.float32)
    w = rng.randn(o, c // g, 3, 3).astype(np.float32)
    b = rng.randn(o).astype(np.float32) if bias else None
    if layout == "NHWC":
        x, w = x.transpose(0, 2, 3, 1), w.transpose(2, 3, 1, 0)
    if groups == "C":
        jfn = lambda a, k, *bb: JF.depthwise_conv2d(  # noqa: E731
            a, k, bb[0] if bb else None, stride, padding, dilation,
            data_format=layout)
        pfn = lambda a, k, *bb: PF.depthwise_conv2d(  # noqa: E731
            a, k, bb[0] if bb else None, stride, padding, dilation,
            data_format=layout)
    else:
        jfn = lambda a, k, *bb: JF.conv2d(  # noqa: E731
            a, k, bb[0] if bb else None, stride, padding, dilation, g,
            data_format=layout)
        pfn = lambda a, k, *bb: PF.conv2d(  # noqa: E731
            a, k, bb[0] if bb else None, stride, padding, dilation, g,
            data_format=layout)
    ins = [x, w] + ([b] if bias else [])
    y, vjp = jax.vjp(jfn, *map(jnp.asarray, ins))
    leaves = [t(a).requires_grad_(True) for a in ins]
    py = pfn(*leaves)
    assert tuple(py.shape) == y.shape
    np.testing.assert_allclose(n(py), np.asarray(y), **TOL)
    dy = rng.randn(*y.shape).astype(np.float32)
    py.backward(t(dy))
    for name, got, want in zip(("dx", "dw", "db"), leaves,
                               vjp(jnp.asarray(dy))):
        np.testing.assert_allclose(n(got.grad), np.asarray(want),
                                   err_msg=name, **TOL)


# pool_size, pool_type, stride, padding, global, exclusive
POOL_CASES = [
    (3, "max", 2, 1, False, True),
    (2, "max", 2, 0, False, True),
    (3, "max", 2, "SAME", False, True),
    (3, "max", 1, "VALID", False, True),
    (3, "avg", 2, 1, False, True),
    (3, "avg", 2, 1, False, False),
    (3, "avg", 2, "SAME", False, True),
    (2, "avg", 2, 0, False, True),
    (2, "max", None, 0, True, True),
    (2, "avg", None, 0, True, True),
]


@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
@pytest.mark.parametrize("size,ptype,stride,padding,glob,excl", POOL_CASES)
def test_pool2d_matches_jax(rng, layout, size, ptype, stride, padding, glob,
                            excl):
    """pool2d values and gradients on post-relu inputs (half the entries
    exactly 0, so max windows tie at 0: both send the gradient to the
    first maximum)."""
    from paddle_tpu.ops import nn as JF
    from paddle_tpu_torch.ops import nn as PF
    x = np.maximum(rng.randn(2, 6, 11, 9), 0).astype(np.float32)
    if layout == "NHWC":
        x = x.transpose(0, 2, 3, 1)
    kw = dict(pool_size=size, pool_type=ptype, stride=stride,
              padding=padding, global_pooling=glob, exclusive=excl,
              data_format=layout)
    y, vjp = jax.vjp(lambda a: JF.pool2d(a, **kw), jnp.asarray(x))
    xt = t(x).requires_grad_(True)
    py = PF.pool2d(xt, **kw)
    assert tuple(py.shape) == y.shape
    np.testing.assert_allclose(n(py), np.asarray(y), **TOL)
    dy = rng.randn(*y.shape).astype(np.float32)
    py.backward(t(dy))
    np.testing.assert_allclose(n(xt.grad), np.asarray(vjp(jnp.asarray(dy))[0]),
                               **TOL)


@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
@pytest.mark.parametrize("ptype", ["avg", "max"])
def test_adaptive_pool2d_matches_jax(rng, layout, ptype):
    from paddle_tpu.ops import nn as JF
    from paddle_tpu_torch.ops import nn as PF
    from paddle_tpu_torch.core.enforce import EnforceError
    x = rng.randn(2, 5, 12, 8).astype(np.float32)
    if layout == "NHWC":
        x = x.transpose(0, 2, 3, 1)
    y = JF.adaptive_pool2d(jnp.asarray(x), (3, 2), ptype, layout)
    np.testing.assert_allclose(
        n(PF.adaptive_pool2d(t(x), (3, 2), ptype, layout)), np.asarray(y),
        **TOL)
    with pytest.raises(EnforceError):
        PF.adaptive_pool2d(t(x), 5, ptype, layout)


@pytest.mark.parametrize("args", [(3, "max", 2, 1, False),
                                  (2, "avg", None, 0, False),
                                  (2, "avg", None, 0, True)])
def test_pool2d_layer_matches_jax(rng, args):
    """``nn.Pool2D(pool_size, pool_type, pool_stride, pool_padding,
    global_pooling)`` over NCHW."""
    from paddle_tpu import nn as jnn
    from paddle_tpu_torch import nn as pnn
    x = rng.randn(2, 3, 9, 8).astype(np.float32)
    want = jnn.Pool2D(*args).apply({}, jnp.asarray(x))
    np.testing.assert_allclose(n(pnn.Pool2D(*args)(t(x))), np.asarray(want),
                               **TOL)


def _bn_inputs(rng, layout, dtype):
    x = (rng.randn(4, 6, 5, 7) * 2 + 1.5).astype(np.float32)
    if layout == "NHWC":
        x = x.transpose(0, 2, 3, 1)
    scale = (rng.rand(6) + 0.5).astype(np.float32)
    bias = rng.randn(6).astype(np.float32)
    mean = rng.randn(6).astype(np.float32)
    var = (rng.rand(6) + 0.5).astype(np.float32)
    jx = [jnp.asarray(a).astype(dtype) for a in (x, scale, bias, mean, var)]
    px = [t(a).to(getattr(torch, dtype)) for a in (x, scale, bias, mean, var)]
    return jx, px


@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
@pytest.mark.parametrize("training", [True, False])
def test_batch_norm_matches_jax(rng, layout, training):
    """f32 batch_norm: the output, the new running statistics and the
    gradients of x, scale and bias (through the batch statistics in
    training mode)."""
    from paddle_tpu.ops import nn as JF
    from paddle_tpu_torch.ops import nn as PF
    jx, px = _bn_inputs(rng, layout, "float32")
    kw = dict(training=training, data_format=layout)
    (y, jm, jv), vjp = jax.vjp(
        lambda a, s, b: JF.batch_norm(a, s, b, jx[3], jx[4], **kw), *jx[:3])
    leaves = [p.requires_grad_(True) for p in px[:3]]
    py, pm, pv = PF.batch_norm(*leaves, px[3], px[4], **kw)
    for got, want in ((py, y), (pm, jm), (pv, jv)):
        np.testing.assert_allclose(n(got), np.asarray(want), **TOL)
    dy = rng.randn(*y.shape).astype(np.float32)
    py.backward(t(dy))
    zero = jnp.zeros_like(jm)
    for name, got, want in zip(("dx", "dscale", "dbias"), leaves,
                               vjp((jnp.asarray(dy), zero, zero))):
        np.testing.assert_allclose(n(got.grad), np.asarray(want),
                                   err_msg=name, **TOL)


@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
def test_batch_norm_bf16_with_bf16_statistics_matches_jax(rng, layout):
    """bf16 x, scale, bias and running statistics (as the bf16 policy
    hands them over): f32 batch statistics, the running update in bf16
    with the constants rounded to bf16 (0.9 -> 0.8984375, 1 - 0.9 ->
    0.1015625), the normalization in bf16. Everything comes back bf16;
    the output within 2^-7 of its scale, the statistics within one bf16
    rounding."""
    from paddle_tpu.ops import nn as JF
    from paddle_tpu_torch.ops import nn as PF
    jx, px = _bn_inputs(rng, layout, "bfloat16")
    y, jm, jv = JF.batch_norm(*jx, training=True, data_format=layout)
    py, pm, pv = PF.batch_norm(*px, training=True, data_format=layout)
    for got, want in ((py, y), (pm, jm), (pv, jv)):
        assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
        want = np.asarray(want, np.float32)
        scale = np.abs(want).max()
        assert np.abs(n(got) - want).max() <= BF16_REL * scale
    np.testing.assert_allclose(n(pm), np.asarray(jm, np.float32),
                               rtol=2.0 ** -8, atol=0)


# ---------------------------------------------------------------- models

def _model_pair(name, training):
    """(jax model, jax variables, port model, NCHW input) at a small size,
    both holding the same params and state."""
    from paddle_tpu import models as JM
    from paddle_tpu_torch import models as PM
    rs = np.random.RandomState(1)
    drop = {} if not training else {"dropout": 0.0}
    spec = {
        "resnet18": (lambda m, **k: m.resnet18(10, small_input=True, **k),
                     (2, 3, 32)),
        "resnet50": (lambda m, **k: m.resnet50(10, **k), (2, 3, 64)),
        "vgg11": (lambda m, **k: m.VGG(11, 10, **drop, **k), (2, 3, 32)),
        "se_resnext": (lambda m, **k: m.SEResNeXt(
            (1, 1, 1, 1), num_classes=10, **k), (2, 3, 64)),
        "convnet": (lambda m, **k: m.ConvNet(10, **k), (2, 1, 28)),
        "softmax_regression": (lambda m, **k: m.SoftmaxRegression(10, **k),
                               (2, 1, 28)),
        "mlp": (lambda m, **k: m.MLP(10, **k), (2, 1, 28)),
    }[name]
    make, (b, c, s) = spec
    pm = make(PM, device="cpu", seed=3)
    pm.train(training)
    return make(JM), _variables(pm), pm, rs.rand(b, c, s, s).astype(np.float32)


def _variables(pm):
    """The port model's weights and running statistics as the JAX
    package's variables (drawn by the port: the JAX package's own init
    takes 10-20 s a model on the CPU)."""
    from paddle_tpu_torch import bridge
    return jax.tree_util.tree_map(jnp.asarray, {
        "params": bridge.export_params(pm), "state": bridge.export_state(pm)})


MODELS = ["resnet18", "resnet50", "vgg11", "se_resnext", "convnet",
          "softmax_regression", "mlp"]


@pytest.mark.parametrize("training", [True, False])
@pytest.mark.parametrize("name", MODELS)
def test_model_logits_match_jax(name, training):
    """Logits of the port's forward against JAX's ``apply`` (batch
    statistics in training mode, running ones in eval mode); in training
    mode also every updated running statistic."""
    from paddle_tpu_torch import bridge
    jm, variables, pm, x = _model_pair(name, training)
    bar = 1e-3 if (name, training) == ("resnet50", True) else 1e-4

    def held(got, want, what):
        err = np.abs(got - want).max()
        assert err <= bar * max(1.0, np.abs(want).max()), (what, err, bar)

    out = jm.apply(variables, jnp.asarray(x), training=training)
    with torch.no_grad():
        got = n(pm(t(x)))
    if training and isinstance(out, tuple):
        out, new_state = out
        want = bridge.flatten(_np(new_state))
        for key, val in bridge.flatten(bridge.export_state(pm)).items():
            held(val, want[key], key)
    assert got.shape == out.shape
    held(got, np.asarray(out), "logits")


def test_linear_regression_matches_jax(rng):
    from paddle_tpu.models.mnist import LinearRegression as JLR
    from paddle_tpu_torch import bridge
    from paddle_tpu_torch.models import LinearRegression
    jm = JLR(13)
    params = jm.init(jax.random.key(0))["params"]
    pm = LinearRegression(13, device="cpu")
    bridge.load_params(pm, _np(params))
    x = rng.randn(5, 13).astype(np.float32)
    want = jm.apply({"params": params, "state": {}}, jnp.asarray(x))
    with torch.no_grad():
        np.testing.assert_allclose(n(pm(t(x))), np.asarray(want), **TOL)


def test_resnet_parameter_and_state_names_are_the_references():
    """161 params and 106 running statistics at depth 50, under the
    reference's paths and in its storage (the stem's HWIO kernel)."""
    from paddle_tpu.models.resnet import resnet50 as jresnet50
    from paddle_tpu_torch import bridge
    from paddle_tpu_torch.models import resnet50
    variables = jax.eval_shape(lambda: jresnet50(10).init(jax.random.key(0)))
    jp = {k: tuple(v.shape) for k, v in bridge.flatten(
        variables["params"]).items()}
    js = {k: tuple(v.shape) for k, v in bridge.flatten(
        variables["state"]).items()}
    pm = resnet50(10, device="cpu")
    pp = {k: tuple(v.shape) for k, v in pm.named_parameters()}
    ps = {k: tuple(v.shape) for k, v in pm.named_buffers()}
    assert (len(pp), len(ps)) == (161, 106)
    assert pp == jp and ps == js
    assert pp["stem.conv.weight"] == (7, 7, 3, 64)
    assert "stages.0.0.conv1.bn.scale" in pp
    assert "stages.0.0.conv1.bn.mean" in ps
    assert all(b.dtype == torch.float32 for b in pm.buffers())


def test_bridge_round_trips_params_and_state(rng):
    """JAX params and state into the port and back, bit for bit; a
    missing or extra state leaf raises."""
    from paddle_tpu.models.vision_cls import VGG as JVGG
    from paddle_tpu_torch import bridge
    from paddle_tpu_torch.models import VGG
    variables = jax.tree_util.tree_map(
        lambda a: rng.randn(*a.shape).astype(np.float32),
        jax.eval_shape(lambda: JVGG(11, 10).init(jax.random.key(5))))
    state = variables["state"]
    pm = VGG(11, 10, device="cpu")
    bridge.load_params(pm, variables["params"])
    bridge.load_state(pm, state)
    for got, want in ((bridge.export_params(pm), variables["params"]),
                      (bridge.export_state(pm), state)):
        got, want = bridge.flatten(got), bridge.flatten(want)
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
    flat = bridge.flatten(state)
    extra = dict(flat, **{"blocks.0.bn.extra": flat["blocks.0.bn.mean"]})
    with pytest.raises(KeyError):
        bridge.load_state(pm, extra)
    flat.pop("blocks.0.bn.mean")
    with pytest.raises(KeyError):
        bridge.load_state(pm, flat)


# -------------------------------------------------------------- training

def _train_pair(policy=None, steps=3):
    """``steps`` Momentum(LR, 0.9) steps of ResNet-18 (CIFAR stem, 10
    classes) at 4 x 3 x 32 x 32 (centered images) on both sides, as
    ``bench.py:1228`` trains ResNet-50: the mean softmax cross entropy, the
    BN state an argument of the reference's minimize (under ``policy`` cast
    to the compute dtype and back), the port's buffers. Returns (jax
    losses, params, state, port losses, model)."""
    import paddle_tpu as pt
    from paddle_tpu.models.resnet import resnet18 as jresnet18
    from paddle_tpu.ops import loss as JL
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.models import resnet18
    from paddle_tpu_torch.ops.loss import softmax_with_cross_entropy
    from paddle_tpu_torch.optimizer import Momentum
    rs = np.random.RandomState(2)
    images = rs.rand(4, 3, 32, 32).astype(np.float32) - 0.5
    labels = rs.randint(0, 10, (4, 1)).astype(np.int32)
    jm = jresnet18(10, small_input=True)
    pm = resnet18(10, small_input=True, device="cpu", seed=7)
    variables = _variables(pm)
    params, state = variables["params"], variables["state"]
    jopt = pt.optimizer.Momentum(LR, 0.9)
    if policy is not None:
        jopt = pt.amp.decorate(jopt, pt.amp.bf16_policy())
    ostate = jopt.init(params)

    def loss_fn(p, im, lb, st):
        out, new_state = jm.apply({"params": p, "state": st}, im,
                                  training=True)
        return jnp.mean(JL.softmax_with_cross_entropy(out, lb)), new_state

    step = jax.jit(lambda p, o, st: jopt.minimize(
        loss_fn, p, o, jnp.asarray(images), jnp.asarray(labels), st))
    popt = Momentum(pm.parameters(), LR, 0.9)
    if policy is not None:
        popt = amp.decorate(popt, amp.bf16_policy())
    jl, pl = [], []
    for _ in range(steps):
        loss, params, ostate, state = step(params, ostate, state)
        jl.append(float(loss))
        pl.append(float(popt.minimize(
            pm, lambda m, im, lb: softmax_with_cross_entropy(
                m(im), lb).mean(), t(images), t(labels))))
    return jl, _np(params), _np(state), pl, pm


def test_resnet18_momentum_steps_match_jax():
    """Three f32 Momentum steps: each loss, every parameter and every
    running statistic within 1e-4."""
    from paddle_tpu_torch import bridge
    jl, params, state, pl, pm = _train_pair()
    np.testing.assert_allclose(pl, jl, rtol=1e-4, atol=1e-4)
    want = bridge.flatten(params)
    for k, v in bridge.flatten(bridge.export_params(pm)).items():
        np.testing.assert_allclose(v, want[k], rtol=1e-4, atol=1e-4,
                                   err_msg=k)
    want = bridge.flatten(state)
    for k, v in bridge.flatten(bridge.export_state(pm)).items():
        np.testing.assert_allclose(v, want[k], rtol=1e-4, atol=1e-4,
                                   err_msg=k)


def test_resnet18_bf16_policy_steps_match_jax():
    """Three ``amp.decorate(Momentum, bf16_policy())`` steps with the BN
    state cast to bf16 for the step and back (``amp.py:179``/``:182``):
    each loss within 2^-7 relative; every running statistic an exact bf16
    value, f32-stored, and within 2^-5 of its leaf's largest JAX value
    (see the module's docstring)."""
    from paddle_tpu_torch import bridge
    jl, _, state, pl, pm = _train_pair(policy="bf16")
    np.testing.assert_allclose(pl, jl, rtol=BF16_REL, atol=0)
    want = bridge.flatten(state)
    for k, b in pm.named_buffers():
        assert b.dtype == torch.float32, k
        assert torch.equal(b, b.to(torch.bfloat16).float()), k
        assert np.abs(n(b) - want[k]).max() <= BF16_STATS_REL * np.abs(
            want[k]).max(), k


def test_resnet18_gradient_on_offset_images_nearer_exact_than_reference():
    """bench.py's images (uniform in [0, 1), not centered): the stem's
    one-pass variance cancels (mean^2 / var up to 9), and the reference's
    f32 sums on XLA's CPU backend lose enough there that its gradients
    lie about 3e-2 (relative L2) from the same formula taken in f64; the
    port's lie within 1e-4 of it. So the port is held to the f64
    evaluation of its own code (the statistics' f32 cast kept) at 1e-4,
    and the reference to it at 1e-1; the JAX comparison at 1e-4 uses
    centered images (``_train_pair``)."""
    from paddle_tpu.models.resnet import resnet18 as jresnet18
    from paddle_tpu.ops import loss as JL
    from paddle_tpu_torch import bridge
    from paddle_tpu_torch.models import resnet18
    from paddle_tpu_torch.ops.loss import softmax_with_cross_entropy
    rs = np.random.RandomState(2)
    images = rs.rand(4, 3, 32, 32).astype(np.float32)
    labels = rs.randint(0, 10, (4, 1)).astype(np.int32)
    pm = resnet18(10, small_input=True, device="cpu", seed=7)
    variables = _variables(pm)
    jm = jresnet18(10, small_input=True)

    def jloss(p):
        out, _ = jm.apply({"params": p, "state": variables["state"]},
                          jnp.asarray(images), training=True)
        return jnp.mean(JL.softmax_with_cross_entropy(out, labels))

    jgrad = _np(jax.jit(jax.grad(jloss))(variables["params"]))
    grads = {}
    for dtype in (torch.float32, torch.float64):
        model = resnet18(10, small_input=True, device="cpu", seed=7).to(dtype)
        softmax_with_cross_entropy(model(t(images).to(dtype)), t(labels)) \
            .mean().backward()
        grads[dtype] = {k: p.grad.double() for k, p in
                        model.named_parameters()}
    jflat = bridge.flatten(jgrad)
    for k, exact in grads[torch.float64].items():
        scale = float(exact.norm())
        assert float((grads[torch.float32][k] - exact).norm()) <= \
            1e-4 * scale, k
        assert float((torch.from_numpy(jflat[k]).double() - exact).norm()) \
            <= 1e-1 * scale, k
