"""The port's registered op surface against the JAX package's, on the CPU.

* The name set: the port's ``list_ops()`` is a subset of the JAX
  package's, and the JAX names it lacks are exactly ``STILL_TO_PORT``.
* One parity case per registered port name (aliases included): the same
  numpy inputs, made from a seed, through ``GLOBAL_OP_REGISTRY.get(name)``
  of both packages. Tolerances: float outputs within 1e-5 absolute and
  1e-5 relative (f32 sums in another order; the transcendental and loss
  ops within 1e-5 relative); integer and bool outputs exactly (by value:
  the port's indices are int64 where the reference's are int32). A few
  detection ops that decode boxes through exp and a perspective solve are
  held at 1e-4, as their own tests hold them.
* A gradient case for each differentiable name (the names of
  ``tests/test_grad_sweep.py``'s ``NON_DIFF`` are the exceptions): the
  gradient of a fixed random weighting of every float output with
  respect to every float input, ``jax.grad`` against ``torch.autograd``,
  within 1e-4 relative and 1e-5 absolute.
* The random ops (``uniform_random``, ``gaussian_random``, ``randint``,
  ``randperm``, ``multinomial``, ``dropout``) are held to shape, dtype,
  range, seeded determinism and moments; ``nce_loss`` and
  ``sampled_softmax_with_cross_entropy`` are fed the negatives that
  ``jax.random.randint`` draws from the reference's key.

The JAX calls of the detection family run under one ``jax.jit`` each
(op-by-op dispatch of their loops is slow on this CPU).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu  # noqa: F401  (fills the JAX registry)
import paddle_tpu_torch.ops  # noqa: F401  (fills the port's)
from paddle_tpu.core import ragged as jrg
from paddle_tpu.core.registry import GLOBAL_OP_REGISTRY as JREG
from paddle_tpu_torch.core import ragged as prg
from paddle_tpu_torch.core.registry import GLOBAL_OP_REGISTRY as PREG
from paddle_tpu_torch.ops import loss as ploss
from paddle_tpu_torch.ops import tail as ptail
from test_grad_sweep import NON_DIFF

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)

#: the JAX package's names the port does not register yet (every one of
#: its 400 names is registered)
STILL_TO_PORT = set()

RANDOM = ("uniform_random", "gaussian_random", "randint", "randperm",
          "multinomial", "sampling_id", "random_crop",
          "uniform_random_batch_size_like",
          "gaussian_random_batch_size_like")


# ------------------------------------------------------------ inputs

def F(*shape, seed=0, lo=-1.0, hi=1.0):
    rs = np.random.RandomState(seed)
    return (rs.rand(*shape) * (hi - lo) + lo).astype(np.float32)


def N(*shape, seed=0, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


def I(lo, hi, *shape, seed=0):
    return np.random.RandomState(seed).randint(lo, hi, shape).astype(
        np.int32)


def A(x, dtype=np.float32):
    return np.asarray(x, dtype)


def softmaxed(*shape, seed=0):
    x = N(*shape, seed=seed)
    e = np.exp(x - x.max(-1, keepdims=True))
    return (e / e.sum(-1, keepdims=True)).astype(np.float32)


def rand_boxes(n, seed=0, lo=0.0, hi=10.0):
    rng = np.random.RandomState(seed)
    x1 = rng.uniform(lo, hi - 1, (n, 1))
    y1 = rng.uniform(lo, hi - 1, (n, 1))
    x2 = x1 + rng.uniform(0.5, hi - 1, (n, 1))
    y2 = y1 + rng.uniform(0.5, hi - 1, (n, 1))
    return np.concatenate([x1, y1, x2, y2], -1).astype(np.float32)


@dataclasses.dataclass
class Rag:
    """A ragged batch: RaggedBatch(values, row_lengths) in each package."""
    values: object
    lengths: object


@dataclasses.dataclass
class Key:
    """``jax.random.key(seed)`` / ``torch.Generator().manual_seed(seed)``."""
    seed: int


@dataclasses.dataclass
class Both:
    """One value for the JAX call and another for the port's."""
    j: object
    p: object


class Case:
    def __init__(self, *args, port_kw=None, tol=None, **kw):
        self.args, self.kw = args, kw
        self.port_kw = port_kw or {}
        self.tol = tol or TOL


@dataclasses.dataclass
class Slot:
    i: int


def _lift(a, leaves):
    """``a`` with every numpy array replaced by a Slot into ``leaves``."""
    if isinstance(a, np.ndarray):
        leaves.append(a)
        return Slot(len(leaves) - 1)
    if isinstance(a, Rag):
        return Rag(_lift(a.values, leaves), _lift(a.lengths, leaves))
    if isinstance(a, list):
        return [_lift(x, leaves) for x in a]
    if isinstance(a, tuple):
        return tuple(_lift(x, leaves) for x in a)
    if isinstance(a, dict):
        return {k: _lift(v, leaves) for k, v in a.items()}
    return a


def _fill(a, arrs, side):
    if isinstance(a, Slot):
        return arrs[a.i]
    if isinstance(a, Rag):
        cls = jrg.RaggedBatch if side == "jax" else prg.RaggedBatch
        return cls(_fill(a.values, arrs, side), _fill(a.lengths, arrs, side))
    if isinstance(a, Key):
        return (jax.random.key(a.seed) if side == "jax"
                else torch.Generator().manual_seed(a.seed))
    if isinstance(a, Both):
        return a.j if side == "jax" else a.p
    if isinstance(a, list):
        return [_fill(x, arrs, side) for x in a]
    if isinstance(a, tuple):
        return tuple(_fill(x, arrs, side) for x in a)
    if isinstance(a, dict):
        return {k: _fill(v, arrs, side) for k, v in a.items()}
    return a


def _leaves_of(out):
    """Every array of an output (tensors, tuples, lists, dicts, ragged
    batches), as numpy, in a fixed order."""
    if out is None:
        return []
    if isinstance(out, (jrg.RaggedBatch, prg.RaggedBatch)):
        return _leaves_of(out.values) + _leaves_of(out.row_lengths)
    if isinstance(out, (jrg.NestedRagged, prg.NestedRagged)):
        return _leaves_of(out.values) + _leaves_of(list(out.lengths))
    if isinstance(out, (list, tuple)):
        return [x for o in out for x in _leaves_of(o)]
    if isinstance(out, dict):
        return [x for k in sorted(out) for x in _leaves_of(out[k])]
    if isinstance(out, torch.Tensor):
        out = out.detach()
        return [(out.float() if out.dtype == torch.bfloat16
                 else out).numpy()]
    return [np.asarray(out)]


def _out_tensors(out):
    """The float tensors of a port output, in :func:`_leaves_of` order
    (None where the leaf is not a float tensor)."""
    if out is None:
        return []
    if isinstance(out, prg.RaggedBatch):
        return _out_tensors(out.values) + _out_tensors(out.row_lengths)
    if isinstance(out, prg.NestedRagged):
        return _out_tensors(out.values) + _out_tensors(list(out.lengths))
    if isinstance(out, (list, tuple)):
        return [x for o in out for x in _out_tensors(o)]
    if isinstance(out, dict):
        return [x for k in sorted(out) for x in _out_tensors(out[k])]
    if isinstance(out, torch.Tensor) and out.is_floating_point():
        return [out]
    return [None]


def _out_jax(out):
    if out is None:
        return []
    if isinstance(out, jrg.RaggedBatch):
        return _out_jax(out.values) + _out_jax(out.row_lengths)
    if isinstance(out, jrg.NestedRagged):
        return _out_jax(out.values) + _out_jax(list(out.lengths))
    if isinstance(out, (list, tuple)):
        return [x for o in out for x in _out_jax(o)]
    if isinstance(out, dict):
        return [x for k in sorted(out) for x in _out_jax(out[k])]
    a = jnp.asarray(out)
    return [a if jnp.issubdtype(a.dtype, jnp.floating) else None]


def _spec(name):
    case = case_of(name)
    leaves = []
    targs, tkw = _lift(case.args, leaves), _lift(case.kw, leaves)
    return case, leaves, targs, tkw


def _call_jax(name, targs, tkw, arrs):
    return JREG.get(name)(*_fill(targs, arrs, "jax"),
                          **_fill(tkw, arrs, "jax"))


def run_jax(name, case=None):
    """The reference's output for ``name`` on its case, op by op."""
    case = case or case_of(name)
    leaves = []
    targs, tkw = _lift(case.args, leaves), _lift(case.kw, leaves)
    return _call_jax(name, targs, tkw, [jnp.asarray(x) for x in leaves])


def run_port(name, case=None):
    case = case or case_of(name)
    leaves = []
    targs, tkw = _lift(case.args, leaves), _lift(case.kw, leaves)
    arrs = [torch.from_numpy(np.array(x)) for x in leaves]
    return PREG.get(name)(*_fill(targs, arrs, "port"),
                          **_fill(tkw, arrs, "port"), **case.port_kw)


def assert_same(got, want, tol=TOL):
    g, w = _leaves_of(got), _leaves_of(want)
    assert len(g) == len(w), (len(g), len(w))
    for a, b in zip(g, w):
        assert a.shape == b.shape, (a.shape, b.shape)
        if b.dtype.kind in "iub":
            np.testing.assert_array_equal(a, b)
        else:
            np.testing.assert_allclose(a, b, equal_nan=True, **tol)


# ------------------------------------------------------------ the cases

X34 = N(3, 4, seed=1, scale=2.0)
POS = F(3, 4, seed=2, lo=0.2, hi=2.0)
X234 = N(2, 3, 4, seed=3)
B = A([[True, False, True], [False, False, True]], bool)
B2 = A([[True, True, False], [False, True, True]], bool)
IMG = N(1, 2, 5, 5, seed=4)


def unary(x=X34):
    return Case(x)


def _ew(name):
    """x ``[2, 3, 4]`` and y ``[3]`` aligned at axis 1; positive operands
    where the op needs them."""
    y = F(3, seed=5, lo=0.5, hi=2.0)
    if name in ("elementwise_pow", "elementwise_div", "elementwise_mod",
                "elementwise_floordiv"):
        return Case(F(2, 3, 4, seed=6, lo=0.5, hi=3.0), y, axis=1)
    return Case(X234, y, axis=1)


def _seq_batch(seed=7, d=3, lengths=(3, 0, 2)):
    return Rag(N(sum(lengths), d, seed=seed), A(lengths, np.int32))


def _ids_batch(lengths=(3, 2, 4), seed=8, hi=5):
    return Rag(I(0, hi, sum(lengths), seed=seed), A(lengths, np.int32))


def _beam_fn(v=5, k=2):
    table = np.log(softmaxed(v, v, seed=9))

    def jfn(tokens, state):
        return jnp.asarray(table)[tokens] + state[:, :1] * 0.0, state

    def pfn(tokens, state):
        return torch.from_numpy(table)[tokens.long()] + state[:, :1] * 0.0, \
            state
    return Both(jfn, pfn)


def _case_pairs():
    return Both(
        [(jnp.asarray(False), lambda: jnp.full((3,), 1.0)),
         (jnp.asarray(True), lambda: jnp.full((3,), 2.0))],
        [(torch.tensor(False), lambda: torch.full((3,), 1.0)),
         (torch.tensor(True), lambda: torch.full((3,), 2.0))])


def _rpn_case():
    anchors = np.concatenate([np.tile([[0, 0, 10, 10]], (6, 1)),
                              rand_boxes(10, 3, 0, 60)]).astype(np.float32)
    gts = A([[0, 0, 10, 10], [30, 30, 50, 45]])
    key = jax.random.key(4)
    r1, r2 = jax.random.split(key)
    draws = (np.array(jax.random.uniform(r1, (16,))),
             np.array(jax.random.uniform(r2, (16,))))
    return Case(Both(key, None), anchors, gts, rpn_batch_size_per_im=8,
                rpn_fg_fraction=0.25, port_kw=dict(test_uniforms=draws))


def _proposal_case():
    rois = rand_boxes(20, 4, 0, 40)
    key = jax.random.key(6)
    r1, r2 = jax.random.split(key)
    draws = (np.array(jax.random.uniform(r1, (20,))),
             np.array(jax.random.uniform(r2, (20,))))
    return Case(Both(key, None), rois, A([1, 3, 2], np.int32),
                A([[0, 0, 10, 10], [20, 20, 35, 30], [5, 15, 25, 38]]),
                A([True, True, True], bool), batch_size_per_im=12,
                fg_fraction=0.25, class_num=4,
                port_kw=dict(test_uniforms=draws))


def _ssd_case():
    priors = rand_boxes(12, 11, 0, 1.0) / 10.0
    loc = N(2, 12, 4, seed=12, scale=0.1)
    conf = N(2, 12, 4, seed=13)
    gt = np.zeros((2, 3, 4), np.float32)
    gt[0, 0] = priors[2] + 0.01
    gt[0, 1] = priors[7] - 0.01
    gt[1, 0] = priors[5]
    lbl = A([[1, 2, 0], [3, 0, 0]], np.int32)
    return Case(loc[0], conf[0], gt[0], lbl[0], priors)


def _yolo_loss_case():
    gt = np.zeros((2, 5, 4), np.float32)
    gt[:, 0] = [0.5, 0.5, 0.3, 0.4]
    gt[:, 1] = [0.2, 0.3, 0.1, 0.2]
    gt[1, 2] = [0.8, 0.1, 0.6, 0.5]
    lbl = A([[0, 2, 0, 0, 0], [1, 0, 2, 0, 0]], np.int32)
    return Case(N(2, 24, 4, 4, seed=14), gt, lbl,
                anchors=[10, 13, 16, 30, 33, 23, 30, 61, 62, 45, 59, 119],
                anchor_mask=[0, 1, 2], class_num=3, downsample_ratio=32,
                ignore_thresh=0.5, tol=dict(rtol=1e-4, atol=1e-4))


def _retina_out_case():
    levels = []
    for i, n in enumerate((20, 8)):
        levels.append((N(n, 4, seed=30 + i, scale=0.1),
                       F(n, 3, seed=32 + i, lo=0.0, hi=1.0),
                       rand_boxes(n, 34 + i, 0, 60)))
    return Case([lv[0] for lv in levels], [lv[1] for lv in levels],
                [lv[2] for lv in levels], (64.0, 60.0), score_threshold=0.2,
                nms_top_k=10, keep_top_k=15, nms_threshold=0.4,
                tol=dict(rtol=1e-4, atol=1e-4))


def _paged_case():
    q = N(2, 2, 8, seed=40)
    kp, vp = N(5, 2, 4, 8, seed=41), N(5, 2, 4, 8, seed=42)
    table = A([[1, 3, 0], [4, 2, 0]], np.int32)
    return Case(q, kp, vp, table, A([6, 0], np.int32))


def _mha_case(use_flash):
    e = 8
    ws = [N(e, e, seed=50 + i, scale=0.3) for i in range(4)]
    bs = [N(e, seed=60 + i, scale=0.1) for i in range(4)]
    return Case(N(2, 5, e, seed=49), *ws, *bs, num_heads=2, causal=True,
                use_flash=use_flash)


def _lstm_params(d=3, h=4, seed=70):
    return (N(d, 4 * h, seed=seed, scale=0.5),
            N(h, 4 * h, seed=seed + 1, scale=0.5),
            N(4 * h, seed=seed + 2, scale=0.1))


def _tree_coef(edges, n, depth):
    from paddle_tpu.ops.graph import tree_patch_coefficients
    return tree_patch_coefficients(np.asarray([edges]), n, depth)


CASES = {
    # --- activations
    "relu": unary(), "relu6": Case(X34 * 4), "leaky_relu": unary(),
    "prelu": Case(X34, F(4, seed=9, lo=0.1, hi=0.3)), "elu": unary(),
    "selu": unary(), "gelu": unary(), "sigmoid": unary(),
    "logsigmoid": unary(), "hard_sigmoid": Case(X34 * 3), "tanh": unary(),
    "tanh_shrink": unary(), "hard_shrink": unary(), "softshrink": unary(),
    "softplus": unary(), "softsign": unary(), "swish": Case(X34, beta=1.5),
    "silu": unary(), "hard_swish": Case(X34 * 3), "mish": unary(),
    "brelu": Case(X34 * 15, t_min=-3.0, t_max=20.0),
    "thresholded_relu": Case(X34, threshold=0.3), "stanh": unary(),
    "softmax": Case(X234, axis=1), "log_softmax": Case(X234),
    "maxout": Case(N(2, 6, 3, 3, seed=10), 2),
    # --- math
    "matmul": Case(X234, N(2, 5, 4, seed=11), transpose_y=True, alpha=0.5),
    "mul": Case(X234, N(4, 5, seed=12), x_num_col_dims=2),
    "bmm": Case(X234, N(2, 4, 5, seed=13)),
    "dot": Case(X34, N(3, 4, seed=14)),
    **{f"elementwise_{op}": _ew(f"elementwise_{op}")
       for op in ("add", "sub", "mul", "div", "max", "min", "pow", "mod",
                  "floordiv")},
    "exp": unary(), "log": unary(POS), "log2": unary(POS),
    "log10": unary(POS), "log1p": unary(POS), "sqrt": unary(POS),
    "rsqrt": unary(POS), "abs": unary(), "ceil": unary(), "floor": unary(),
    "round": unary(), "sign": unary(), "square": unary(),
    "reciprocal": unary(POS), "sin": unary(), "cos": unary(),
    "tan": unary(), "asin": unary(F(3, 4, seed=15, lo=-0.9, hi=0.9)),
    "acos": unary(F(3, 4, seed=16, lo=-0.9, hi=0.9)), "atan": unary(),
    "sinh": unary(), "cosh": unary(), "erf": unary(),
    "pow": Case(POS, 2.5),
    "scale": Case(X34, 2.0, 0.5, False),
    "clip": Case(X34, -0.3, 0.4),
    "clip_by_norm": Case(X34, 1.0),
    "reduce_sum": Case(X234, [0, 2], True),
    "reduce_mean": Case(X234, 1),
    "reduce_max": Case(X234, [1, 2]),
    "reduce_min": Case(X234, -1, True),
    "reduce_prod": Case(X234, [0, 2]),
    "reduce_all": Case(B, 1), "reduce_any": Case(B, None),
    "logsumexp": Case(X234, [1]),
    "mean": unary(), "sum": Case([X34, POS, X34 * 2]),
    "cumsum": Case(X234, 1, True, True), "cumprod": Case(POS, 1),
    "norm": Case(X34, 3, 1), "frobenius_norm": Case(X234, [0, 1]),
    "kron": Case(N(2, 3, seed=17), N(3, 2, seed=18)),
    "addmm": Case(N(3, 5, seed=19), X34, N(4, 5, seed=20), 0.5, 2.0),
    "isfinite": Case(A([[1.0, np.inf], [0.0, 2.0]])),
    "isnan": Case(A([1.0, np.nan, 2.0])),
    "isinf": Case(A([1.0, -np.inf, np.nan])),
    "increment": Case(X34, 2.5),
    "maximum": Case(X34, N(3, 4, seed=21)),
    "minimum": Case(X34, N(3, 4, seed=22)),
    # --- tensor ops
    "cast": Case(X34 * 3, "float16"),
    "concat": Case([X34, POS], 1),
    "split": Case(N(2, 6, seed=23), [1, 3, 2], 1),
    "stack": Case([X34, POS], 1), "unstack": Case(X234, 1),
    "squeeze": Case(N(1, 3, 1, 4, seed=24), [0, 2]),
    "unsqueeze": Case(X34, [0, 2]), "reshape": Case(X234, [4, -1]),
    "flatten": Case(X234, 2), "transpose": Case(X234, [2, 0, 1]),
    "slice": Case(X234, [0, 2], [0, 1], [1, 3]),
    "strided_slice": Case(X234, [1, 2], [0, 3], [3, 0], [2, -1]),
    "gather": Case(X234, A([[2, 0], [1, 1]], np.int32), 1),
    "gather_nd": Case(N(3, 4, 5, seed=25), A([[0, 1], [2, 3]], np.int32)),
    "scatter": Case(N(5, 3, seed=26), A([3, 0], np.int32),
                    N(2, 3, seed=27)),
    "scatter_nd_add": Case(N(4, 3, seed=28), A([[1], [3], [1]], np.int32),
                           N(3, 3, seed=29)),
    "expand": Case(X34, [2, 1]), "expand_as": Case(N(1, 3, seed=30), X34.T),
    "broadcast_to": Case(N(1, 4, seed=31), [3, 4]),
    "tile": Case(X34, [2, 2]), "reverse": Case(X234, [0, 2]),
    "roll": Case(X34, 1, 1),
    "top_k": Case(A([[0.5, 0.2, 0.5, 0.9], [1.0, 1.0, 1.0, 0.0]]), 3),
    "argsort": Case(A([[0.5, 0.2, 0.5, 0.9], [1.0, 1.0, 1.0, 0.0]]), 1,
                    True),
    "sort": Case(X34, 0, True), "argmax": Case(X234, 1),
    "argmin": Case(X234),
    "one_hot": Case(A([[0], [3], [5], [1]], np.int32), 4),
    "where": Case(A(X34 > 0, bool), X34, POS),
    "masked_select": Case(X34, A(X34 > 0, bool), 6),
    "unique_with_counts": Case(A([3, 1, 3, 7, 1, 3], np.int32), 8),
    "shard_index": Case(I(0, 20, 8, seed=31), 20, 4, 1),
    "index_select": Case(X234, A([2, 0, 2], np.int32), -1),
    "index_sample": Case(X34, A([[0, 3], [2, 2], [1, 0]], np.int32)),
    "fill_constant": Case([2, 3], "float32", 1.5,
                          port_kw=dict(device="cpu")),
    "fill_constant_batch_size_like": Case(X34, [-1, 2], "int32", 7),
    "zeros_like": unary(), "ones_like": unary(),
    "arange": Case(2, 11, 3, port_kw=dict(device="cpu")),
    "linspace": Case(0.0, 1.0, 7, port_kw=dict(device="cpu")),
    "eye": Case(3, 4, port_kw=dict(device="cpu")),
    "diag": Case(N(3, seed=32)),
    "uniform_random": Case(Key(0), [200, 100], min=-2.0, max=3.0),
    "gaussian_random": Case(Key(1), [200, 100], mean=1.0, std=2.0),
    "randint": Case(Key(2), 3, 11, [200, 100]),
    "randperm": Case(Key(3), 50),
    "multinomial": Case(Key(4), A([0.1, 0.6, 0.3]), 2000),
    "shape": Case(X234), "size": Case(X234),
    "equal": Case(I(0, 3, 3, 4, seed=33), I(0, 3, 3, 4, seed=34)),
    "not_equal": Case(I(0, 3, 3, 4, seed=33), I(0, 3, 3, 4, seed=34)),
    "less_than": Case(X34, POS), "less_equal": Case(X34, X34),
    "greater_than": Case(X34, POS), "greater_equal": Case(X34, POS),
    "logical_and": Case(B, B2), "logical_or": Case(B, B2),
    "logical_xor": Case(B, B2), "logical_not": Case(B),
    "allclose": Case(X34, X34 + 1e-7),
    "pad": Case(X34, [1, 0, 0, 2], 0.5),
    "pad2d": Case(N(1, 2, 3, 4, seed=35), [1, 0, 2, 1], "reflect"),
    "meshgrid": Case(N(3, seed=36), N(4, seed=37)),
    "take_along_axis": Case(X34, A([[0, 3], [2, 2], [1, 0]], np.int32), 1),
    "put_along_axis": Case(X34, A([[0, 3], [2, 1], [1, 0]], np.int32),
                           N(3, 2, seed=38), 1),
    "numel": Case(X234), "rank": Case(X234),
    # --- nn
    "fc": Case(X234, N(12, 5, seed=39), N(5, seed=40), 1, "tanh"),
    "conv2d": Case(IMG, N(3, 2, 3, 3, seed=41), N(3, seed=42), 2, 1),
    "depthwise_conv2d": Case(N(1, 3, 5, 5, seed=43),
                             N(3, 1, 3, 3, seed=44), padding=1),
    "conv3d": Case(N(1, 2, 4, 4, 4, seed=45), N(3, 2, 2, 2, 2, seed=46),
                   N(3, seed=47), 1, "SAME"),
    "conv2d_transpose": Case(N(1, 2, 4, 4, seed=48), N(2, 3, 3, 3, seed=49),
                             N(3, seed=50), 2, 1, 1),
    "pool2d": Case(IMG, 3, "avg", 2, 1),
    "adaptive_pool2d": Case(N(1, 2, 4, 6, seed=51), (2, 3), "max"),
    "batch_norm": Case(N(2, 3, 4, 4, seed=52), F(3, seed=53, lo=0.5),
                       N(3, seed=54), N(3, seed=55), F(3, seed=56, lo=0.5),
                       training=True),
    "layer_norm": Case(X234, N(4, seed=57), N(4, seed=58), 2),
    "rms_norm": Case(X234, N(4, seed=59)),
    "group_norm": Case(N(2, 4, 3, 3, seed=60), N(4, seed=61),
                       N(4, seed=62), 2),
    "instance_norm": Case(N(2, 3, 4, 4, seed=63), N(3, seed=64),
                          N(3, seed=65)),
    "l2_normalize": Case(X34, 0), "lrn": Case(N(1, 6, 3, 3, seed=66)),
    "dropout": Case(X34, Key(5), 0.3, False, "downgrade_in_infer"),
    "lookup_table": Case(A([[1], [0], [3], [1]], np.int32),
                         N(5, 3, seed=67), 1),
    "interpolate": Case(N(1, 2, 4, 5, seed=68), (6, 7), mode="bilinear"),
    "pixel_shuffle": Case(N(1, 8, 2, 3, seed=69), 2),
    "affine_channel": Case(IMG, N(2, seed=70), N(2, seed=71)),
    "unfold": Case(N(1, 2, 5, 5, seed=72), 3, 2, 1),
    "nan_to_num": Case(A([1.0, np.nan, np.inf, -np.inf]), 0.5),
    "fsp_matrix": Case(N(2, 3, 4, 4, seed=73), N(2, 2, 4, 4, seed=74)),
    # --- losses
    "cross_entropy": Case(softmaxed(4, 5, seed=75),
                          A([[1], [4], [-100], [0]], np.int32)),
    "softmax_with_cross_entropy": Case(N(4, 5, seed=76),
                                       A([[1], [4], [-100], [0]], np.int32),
                                       return_softmax=True),
    "sigmoid_cross_entropy_with_logits": Case(
        X34, A(np.random.RandomState(77).rand(3, 4) > 0.5), normalize=True),
    "bce_loss": Case(F(3, 4, seed=78, lo=0.05, hi=0.95),
                     A(np.random.RandomState(79).rand(3, 4) > 0.5)),
    "log_loss": Case(F(3, 4, seed=80, lo=0.05, hi=0.95),
                     A(np.random.RandomState(81).rand(3, 4) > 0.5)),
    "mse_loss": Case(X34, POS), "square_error_cost": Case(X34, POS),
    "l1_loss": Case(X34, POS),
    "smooth_l1_loss": Case(X34, N(3, 4, seed=82), 2.0),
    "huber_loss": Case(X34, N(3, 4, seed=83), 0.7),
    "hinge_loss": Case(X34, A(np.random.RandomState(84).rand(3, 4) > 0.5)),
    "rank_loss": Case(A(np.random.RandomState(85).rand(3, 1) > 0.5),
                      N(3, 1, seed=86), N(3, 1, seed=87)),
    "margin_rank_loss": Case(A([[1.0], [-1.0], [1.0]]), N(3, 1, seed=88),
                             N(3, 1, seed=89), 0.2),
    "bpr_loss": Case(softmaxed(4, 5, seed=90), A([[1], [4], [2], [0]],
                                                   np.int32)),
    "kldiv_loss": Case(np.log(softmaxed(4, 5, seed=91)),
                       softmaxed(4, 5, seed=92), "batchmean"),
    "npair_loss": Case(N(4, 3, seed=93), N(4, 3, seed=94),
                       A([0, 1, 0, 2], np.int32)),
    "cos_sim": Case(X34, N(3, 4, seed=95)),
    "ctc_loss": Case(N(2, 6, 4, seed=96), A([6, 5], np.int32),
                     A([[1, 2, 1], [3, 3, 0]], np.int32),
                     A([3, 2], np.int32)),
    "center_loss": Case(N(4, 3, seed=97), A([0, 2, 0, 4], np.int32),
                        N(5, 3, seed=98)),
    "dice_loss": Case(softmaxed(2, 3, 4, seed=99),
                      A([[0, 3, 1], [2, 2, 0]], np.int32)),
    "hsigmoid": Case(N(4, 3, seed=100), N(5, 3, seed=101),
                     A([0, 5, 3, 2], np.int32), 6, N(5, seed=102)),
    # --- control flow
    "while_loop": Case(lambda v: v[0] < 4, lambda v: (v[0] + 1, v[1] * 1.5),
                       (A(0, np.int32), X34)),
    "cond": Case(A(False, bool), lambda a: a * 2.0, lambda a: a - 1.0, X34),
    "case": Case(_case_pairs(), None),
    "switch_case": Case(A(7, np.int32), [lambda a: a * 2.0,
                                         lambda a: a - 1.0,
                                         lambda a: a * a], X34),
    "scan": Case(lambda c, x: (c + x, c * x), N(4, seed=103),
                 N(5, 4, seed=104), reverse=True),
    "fori_loop": Case(1, 4, lambda i, v: v * 2.0 + i, X34),
    "stop_gradient": unary(),
    "create_array": Case(3, [2, 2], port_kw=dict(device="cpu")),
    "array_write": Case(np.zeros((3, 4), np.float32), A(1, np.int32),
                        N(4, seed=105)),
    "array_read": Case(X34, 1), "array_length": Case(X34),
    "print": Case(X34, "op surface: ", 3),
    # --- attention
    "scaled_dot_product_attention": Case(
        N(2, 2, 5, 4, seed=106), N(2, 2, 6, 4, seed=107),
        N(2, 2, 6, 4, seed=108),
        A(np.random.RandomState(109).rand(2, 1, 5, 6) > 0.3, bool)),
    "multihead_attention": _mha_case(True),
    "paged_decode_attention": _paged_case(),
    "fused_xent": Case(N(6, 8, seed=110), N(11, 8, seed=111),
                       A([1, 10, -100, 3, 0, 7], np.int32), N(11, seed=112),
                       label_smoothing=0.1),
    # --- rnn
    "lstm_cell": Case(N(2, 3, seed=113), N(2, 4, seed=114),
                      N(2, 4, seed=115), *_lstm_params(), forget_bias=1.0),
    "gru_cell": Case(N(2, 3, seed=116), N(2, 4, seed=117),
                     N(3, 12, seed=118, scale=0.5),
                     N(4, 12, seed=119, scale=0.5), N(12, seed=120),
                     N(12, seed=121)),
    "lstm": Case(N(2, 5, 3, seed=122), N(2, 4, seed=123), N(2, 4, seed=124),
                 *_lstm_params(), lengths=A([5, 3], np.int32)),
    "gru": Case(N(2, 5, 3, seed=125), N(2, 4, seed=126),
                N(3, 12, seed=127, scale=0.5), N(4, 12, seed=128, scale=0.5),
                N(12, seed=129), N(12, seed=130),
                lengths=A([2, 5], np.int32), reverse=True),
    "bidirectional_lstm": Case(N(2, 5, 3, seed=131), N(2, 4, seed=132),
                               N(2, 4, seed=133), _lstm_params(seed=134),
                               _lstm_params(seed=137),
                               A([5, 3], np.int32)),
    "beam_search": Case(N(2, 3, seed=140), np.log(softmaxed(2, 3, 5,
                                                             seed=141)), 3),
    "beam_search_decode": Case(_beam_fn(), N(4, 2, seed=142), 0, 1, 2, 4, 2,
                               5),
    # --- crf and metrics
    "linear_chain_crf": Case(N(2, 5, 4, seed=143), N(6, 4, seed=144),
                             I(0, 4, 2, 5, seed=145), A([5, 3], np.int32)),
    "crf_decoding": Case(N(2, 5, 4, seed=146), N(6, 4, seed=147),
                         A([5, 3], np.int32)),
    "edit_distance": Case(I(0, 4, 2, 6, seed=148), A([6, 4], np.int32),
                          I(0, 4, 2, 5, seed=149), A([5, 2], np.int32),
                          True),
    "accuracy": Case(N(6, 5, seed=150), I(0, 5, 6, 1, seed=151), 2),
    "auc": Case(softmaxed(20, 2, seed=152), I(0, 2, 20, 1, seed=153), 64),
    "precision_recall": Case(I(0, 4, 12, seed=154), I(0, 4, 12, seed=155),
                             4),
    "chunk_eval": Case(A([[1, 2, 0, 3, 4], [1, 1, 2, 0, 0]], np.int32),
                       A([[1, 2, 0, 3, 0], [1, 2, 2, 0, 0]], np.int32),
                       A([5, 3], np.int32), "IOB", 2),
    # --- sequence
    "sequence_mask": Case(A([3, 0, 2], np.int32), 4),
    "sequence_pool": Case(_seq_batch(), "max"),
    "sequence_softmax": Case(Rag(N(5, seed=156), A([3, 0, 2], np.int32))),
    "sequence_expand": Case(N(3, 2, seed=157), _ids_batch((2, 0, 3))),
    "sequence_reverse": Case(_seq_batch(seed=158)),
    "sequence_pad": Case(_seq_batch(seed=159), -1.0, 4),
    "sequence_unpad": Case(N(3, 4, 2, seed=160), A([3, 0, 2], np.int32)),
    "sequence_concat": Case([_seq_batch(seed=161),
                             _seq_batch(seed=162, lengths=(1, 2, 0))]),
    "sequence_first_step": Case(_seq_batch(seed=163)),
    "sequence_last_step": Case(_seq_batch(seed=164)),
    "sequence_slice": Case(_seq_batch(seed=165, lengths=(3, 1, 4)),
                           A([1, 0, 2], np.int32), A([2, 1, 1], np.int32)),
    "sequence_enumerate": Case(I(0, 9, 6, seed=166), 3, -1),
    "sequence_erase": Case(_ids_batch(), [2, 4]),
    "sequence_expand_as": Case(N(3, 2, seed=167), _ids_batch((2, 1, 3))),
    "sequence_scatter": Case(N(3, 5, seed=168),
                             Rag(A([0, 4, 2, 1], np.int32),
                                 A([2, 0, 2], np.int32)),
                             Rag(N(4, seed=169), A([2, 0, 2], np.int32))),
    "sequence_conv": Case(_seq_batch(seed=170), N(9, 2, seed=171), -1, 3,
                          N(2, seed=172)),
    "row_conv": Case(_seq_batch(seed=173), N(2, 3, seed=174)),
    "im2sequence": Case(N(2, 2, 4, 5, seed=175), (2, 3), (1, 2),
                        (1, 0, 0, 1)),
    "add_position_encoding": Case(N(2, 5, 6, seed=176), 0.5, 2.0),
    "ctc_align": Case(A([[0, 1, 1, 0, 2, 2], [3, 0, 3, 3, 0, 0]], np.int32),
                      A([6, 4], np.int32)),
    # --- text matching and nets
    "match_matrix_tensor": Case(N(2, 4, 3, seed=177), N(2, 5, 3, seed=178),
                                N(3, 2, 3, seed=179), A([4, 2], np.int32),
                                A([3, 5], np.int32), "tanh"),
    "var_conv_2d": Case(N(2, 2, 4, 5, seed=180), A([4, 3], np.int32),
                        A([5, 2], np.int32), N(3, 2, 3, 3, seed=181)),
    "sequence_topk_avg_pooling": Case(N(2, 2, 4, 5, seed=182),
                                      A([4, 3], np.int32),
                                      A([5, 2], np.int32), [1, 3], 2),
    "glu": Case(N(3, 6, seed=183)),
    "simple_img_conv_pool": Case(IMG, N(3, 2, 3, 3, seed=184),
                                 N(3, seed=185), act="relu"),
    "img_conv_group": Case(IMG, [N(3, 2, 3, 3, seed=186),
                                 N(4, 3, 3, 3, seed=187)],
                           [N(3, seed=188), N(4, seed=189)]),
    "sequence_conv_pool": Case(_seq_batch(seed=190, lengths=(3, 1, 2)),
                               N(9, 2, seed=191)),
    # --- detection
    "iou_similarity": Case(rand_boxes(5, 200), rand_boxes(7, 201), False),
    "box_clip": Case(A([[-5.0, -5.0, 20.0, 30.0], [1, 2, 3, 4]]),
                     (10.0, 15.0)),
    "box_coder": Case(rand_boxes(6, 202), A([0.1, 0.1, 0.2, 0.2]),
                      rand_boxes(6, 203), "encode_center_size", False),
    "prior_box": Case((4, 5), (32, 40), [8.0], [16.0], [2.0], flip=True,
                      clip=True, port_kw=dict(device="cpu")),
    "density_prior_box": Case((2, 3), (16, 24), [4.0, 8.0], [1.0, 2.0],
                              [2, 1], clip=True,
                              port_kw=dict(device="cpu")),
    "anchor_generator": Case((3, 4), [32.0, 64.0], [0.5, 1.0, 2.0],
                             (16.0, 16.0), port_kw=dict(device="cpu")),
    "nms": Case(rand_boxes(12, 204), F(12, seed=205, lo=0.0), 0.4,
                keep_top_k=6),
    "multiclass_nms": Case(rand_boxes(15, 206), F(3, 15, seed=207, lo=0.0),
                           0.3, 8, 6, 0.4, return_index=True),
    "multiclass_nms2": Case(rand_boxes(15, 208), F(3, 15, seed=209, lo=0.0),
                            0.3, 8, 6, 0.4),
    "detection_output": Case(N(20, 4, seed=210, scale=0.2),
                             softmaxed(20, 4, seed=211),
                             rand_boxes(20, 212, 0, 1.0) / 10.0,
                             A([0.1, 0.1, 0.2, 0.2]), 0.45, 10, 8, 0.05),
    "roi_align": Case(N(2, 3, 8, 8, seed=213),
                      A([[0, 0, 7, 7], [2, 2, 6, 5], [1, 0, 5, 7]]),
                      A([0, 1, 0], np.int32), 2, 3, 1.0, 2, True),
    "roi_pool": Case(N(2, 2, 6, 7, seed=214),
                     A([[0, 0, 3, 3], [1, 2, 6, 5], [0, 0, 12, 10]]),
                     A([0, 1, 0], np.int32), 2, 3, 0.5),
    "roi_perspective_transform": Case(
        N(2, 3, 9, 7, seed=215),
        A([[1, 1, 5, 2, 6, 7, 0, 6], [0.5, 0, 6, 1, 6, 8, 1, 7]]),
        A([1, 0], np.int32), 5, 6, tol=dict(rtol=1e-4, atol=1e-4)),
    "yolo_box": Case(N(2, 16, 4, 4, seed=216),
                     A([[128, 128], [96, 64]], np.int32), [10, 13, 16, 30],
                     3, 0.0, 32, tol=dict(rtol=1e-4, atol=1e-4)),
    "yolov3_loss": _yolo_loss_case(),
    "generate_proposals": Case(F(30, seed=217, lo=0.0),
                               N(30, 4, seed=218, scale=0.1),
                               rand_boxes(30, 219, 0, 60),
                               np.ones((30, 4), np.float32), (64.0, 64.0),
                               20, 8, 0.7),
    "bipartite_match": Case(A([[0.9, 0.1, 0.6], [0.8, 0.7, 0.2]]),
                            "per_prediction", 0.5),
    "target_assign": Case(A([[1.0, 2.0], [3.0, 4.0]]),
                          A([1, -1, 0], np.int32), -9.0),
    "mine_hard_examples": Case(A([0.9, 0.1, 0.8, 0.2, 0.5]),
                               A([0, -1, -1, -1, -1], np.int32), 3.0),
    "ssd_loss": _ssd_case(),
    "distribute_fpn_proposals": Case(
        A([[0, 0, 10, 10], [0, 0, 224, 224], [0, 0, 1000, 1000],
           [5, 5, 120, 90]]), 2, 5, 4, 224),
    "box_decoder_and_assign": Case(rand_boxes(5, 220, 0, 40),
                                   A([0.1, 0.1, 0.2, 0.2]),
                                   N(5, 12, seed=221, scale=0.5),
                                   F(5, 3, seed=222, lo=0.0),
                                   tol=dict(rtol=1e-4, atol=1e-4)),
    "rpn_target_assign": _rpn_case(),
    "generate_proposal_labels": _proposal_case(),
    "retinanet_target_assign": Case(
        np.concatenate([A([[0, 0, 10, 10], [100, 100, 110, 110]]),
                        rand_boxes(12, 223, 0, 50)]),
        A([[0, 0, 10, 10], [20, 20, 40, 35], [0, 0, 0, 0]]),
        A([7, 2, 5], np.int32), A([True, True, False], bool)),
    "poly2mask": Case([0.5, 0.2, 7.3, 2.1, 4.4, 6.9, 1.2, 5.5], 9, 8),
    "polys_to_mask_wrt_box": Case(
        [[10, 10, 20, 10, 20, 30, 10, 30], [22, 22, 29, 23, 25, 29]],
        [10, 10, 30, 30], 8),
    "generate_mask_labels": Case(
        A([[0, 0, 10, 10], [20, 20, 30, 30], [2, 1, 9, 12]]),
        A([3, 0, 1], np.int32), [[0, 0, 10, 10], [1, 1, 11, 12]],
        [[[0, 0, 10, 0, 10, 10, 0, 10]],
         [[1, 1, 11, 1, 6, 12], [2, 2, 4, 2, 3, 5]]], 6),
    # --- vision
    "polygon_box_transform": Case(F(2, 4, 3, 5, seed=224)),
    "psroi_pool": Case(F(2, 12, 9, 8, seed=225),
                       A([[0, 0, 7, 7], [1.4, 2.6, 6.2, 8.1]]),
                       A([0, 1], np.int32), 2, 2, 3, 0.5),
    "prroi_pool": Case(F(2, 3, 7, 9, seed=226),
                       A([[0.3, 0.2, 6.1, 5.5], [2.5, 1.0, 8.7, 6.9]]),
                       A([0, 1], np.int32), 2, 3, 0.8),
    "deformable_psroi_pool": Case(
        F(2, 16, 10, 9, seed=227),
        A([[0, 0, 7, 7], [2.4, 1.2, 8.6, 9.3]]), A([0, 1], np.int32),
        N(2, 4, 2, 3, seed=228), output_dim=4, group_size=(2, 2),
        pooled_height=2, pooled_width=3, part_size=(2, 3),
        sample_per_part=2, spatial_scale=0.75, trans_std=0.2),
    "collect_fpn_proposals": Case(
        [A([[0.0, 0, 1, 1], [1, 1, 2, 2], [5, 5, 6, 6]]),
         A([[3.0, 3, 4, 4], [7, 7, 8, 8]])],
        [A([0.9, 0.5, 0.1]), A([0.4, 0.8])], 4),
    "sigmoid_focal_loss": Case(N(6, 3, seed=229, scale=3.0),
                               A([0, 1, 2, 3, 1, 0], np.int32), 2.0),
    "retinanet_detection_output": _retina_out_case(),
    # --- tail
    "label_smooth": Case(softmaxed(3, 4, seed=300), epsilon=0.2),
    "multiplex": Case([X34, POS, X34 * 2], A([[2], [0], [1]], np.int32)),
    "mean_iou": Case(I(0, 4, 12, seed=301), I(0, 4, 12, seed=302), 5),
    "crop_tensor": Case(X234, [1, 2, 3], [1, 1, 0]),
    "crop": Case(X234, [2, 1, 2], [0, 2, 1]),
    "bilinear_tensor_product": Case(X34, N(3, 5, seed=303),
                                    N(2, 4, 5, seed=304), N(2, seed=305)),
    "gather_tree": Case(I(0, 9, 4, 2, 3, seed=306),
                        I(0, 3, 4, 2, 3, seed=307)),
    "hash": Case(I(0, 50000, 5, 2, seed=308), 1000, 3),
    "soft_relu": Case(X34 * 20, 30.0),
    "pad_constant_like": Case(X234, N(2, 2, 3, seed=309), 0.5),
    "ctc_greedy_decoder": Case(N(2, 6, 4, seed=310), A([6, 4], np.int32)),
    "sequence_reshape": Case(Rag(N(6, 4, seed=311), A([2, 0, 4], np.int32)),
                             2),
    "lod_reset": Case(Rag(N(6, 3, seed=312), A([2, 0, 4], np.int32)),
                      A([1, 4, 1], np.int32)),
    "teacher_student_sigmoid_loss": Case(
        X34 * 10, A([[0.0, 1.0, -0.3, -0.8], [1.0, 0.0, -0.5, 1.0],
                     [-0.1, 0.0, 1.0, -0.9]])),
    "continuous_value_model": Case(F(4, 5, seed=313, lo=0.0, hi=3.0), True),
    "adaptive_pool3d": Case(N(1, 2, 4, 4, 6, seed=314), (2, 2, 3), "max"),
    "lod_append": Case(N(6, 2, seed=315), A([2, 1], np.int32),
                       A([3, 1, 2], np.int32)),
    "image_resize_short": Case(N(1, 2, 4, 6, seed=316), 3),
    "spectral_norm": Case(N(4, 3, 2, seed=317), N(4, seed=318),
                          N(6, seed=319), dim=0, power_iters=2),
    "dynamic_lstmp": Case(N(2, 5, 3, seed=320), N(2, 2, seed=321),
                          N(2, 4, seed=322), N(3, 16, seed=323, scale=0.5),
                          N(2, 16, seed=324, scale=0.5),
                          N(4, 2, seed=325, scale=0.5), N(16, seed=326),
                          lengths=A([5, 3], np.int32)),
    "filter_by_instag": Case(N(4, 3, seed=327),
                             A([[1, 0], [2, 3], [0, 0], [3, 5]], np.int32),
                             [3, 7], out_size=5),
    "conv_shift": Case(N(2, 5, seed=328), N(2, 3, seed=329)),
    "squared_l2_distance": Case(X34, N(1, 4, seed=330)),
    "squared_l2_norm": unary(), "l1_norm": unary(),
    "modified_huber_loss": Case(X34 * 2,
                                A(np.random.RandomState(331).rand(3, 4)
                                  > 0.5)),
    "positive_negative_pair": Case(A([0.5, 0.2, 0.5, 0.9, 0.1, 0.4]),
                                   A([1.0, 0.0, 0.0, 2.0, 1.0, 0.0]),
                                   A([0, 0, 0, 0, 1, 1], np.int32)),
    "sample_logits": Case(N(4, 20, seed=332), A([[3], [0], [19], [7]],
                                                np.int32), 5, Key(0),
                          use_customized_samples=True,
                          customized_samples=A(
                              [[3, 3, 1, 2, 5, 6], [0, 4, 0, 9, 9, 1],
                               [19, 2, 3, 4, 18, 19], [7, 1, 2, 3, 4, 5]],
                              np.int32),
                          customized_probabilities=F(4, 6, seed=333, lo=0.01,
                                                     hi=0.2)),
    "similarity_focus": Case(N(2, 3, 4, 5, seed=334), 2, [0, 3]),
    "is_empty": unary(), "minus": Case(X34, POS),
    "scatter_nd": Case(A([[1], [3], [1]], np.int32), N(3, 3, seed=335),
                       [4, 3]),
    "autoincreased_step_counter": Case(A(5, np.int32)),
    "resize_trilinear": Case(N(1, 2, 3, 4, 4, seed=336), size=(5, 6, 3)),
    "merge_selected_rows": Case(A([4, 1, 4, 7, 1], np.int32),
                                N(5, 3, seed=337)),
    "get_tensor_from_selected_rows": Case(A([4, 1, 4, 0], np.int32),
                                          N(4, 3, seed=338), 6),
    "py_func": Case(lambda a: np.asarray(a) * 2 + 1, X34,
                    out_shape_dtype=Both(
                        jax.ShapeDtypeStruct((3, 4), jnp.float32),
                        ptail.ShapeDtype((3, 4), torch.float32))),
    "assign": unary(), "sums": Case([X34, POS, X34 * 3]),
    "has_inf": Case(A([1.0, np.inf, 2.0])),
    "has_nan": Case(A([1.0, 3.0, 2.0])),
    "tensor_array_to_tensor": Case(X234, 1, True),
    "ones": Case([2, 3], "float32", port_kw=dict(device="cpu")),
    "zeros": Case([3, 2], "int32", port_kw=dict(device="cpu")),
    "create_tensor": Case("float32", [2, 3], port_kw=dict(device="cpu")),
    "create_global_var": Case([2, 2], 2.5, "float32",
                              port_kw=dict(device="cpu")),
    "create_parameter": Case([3, 2], "float32", port_kw=dict(device="cpu")),
    "sampling_id": Case(softmaxed(400, 4, seed=339), Key(6)),
    "random_crop": Case(N(3, 6, 7, seed=340), Key(7), [3, 4, 5]),
    "uniform_random_batch_size_like": Case(X34, Key(8), [-1, 500],
                                           min=-2.0, max=1.0),
    "gaussian_random_batch_size_like": Case(X34, Key(9), [-1, 500],
                                            mean=1.0, std=0.5),
    # --- fused
    "conv_fusion": Case(IMG, N(3, 2, 3, 3, seed=341), N(3, seed=342),
                        N(1, 3, 5, 5, seed=343), 1, 1),
    "fused_elemwise_activation": Case(X34, POS * -1.0 + 1.0,
                                      ["elementwise_mul", "relu"]),
    "fused_embedding_fc_lstm": Case(I(0, 6, 2, 5, seed=344),
                                    N(6, 16, seed=345, scale=0.5),
                                    N(2, 4, seed=346), N(2, 4, seed=347),
                                    N(4, 16, seed=348, scale=0.5),
                                    N(16, seed=349),
                                    lengths=A([5, 3], np.int32)),
    "fused_embedding_seq_pool": Case(N(6, 3, seed=350),
                                     I(0, 6, 3, 4, seed=351),
                                     A([4, 0, 2], np.int32), "mean"),
    "fused_fc_elementwise_layernorm": Case(
        X34, N(4, 6, seed=352), N(3, 6, seed=353), N(6, seed=354),
        N(6, seed=355), N(6, seed=356)),
    "fusion_repeated_fc_relu": Case(X34, [N(4, 5, seed=357),
                                          N(5, 3, seed=358)],
                                    [N(5, seed=359), N(3, seed=360)]),
    "fusion_seqconv_eltadd_relu": Case(N(2, 5, 3, seed=361),
                                       N(9, 4, seed=362), N(4, seed=363), 3,
                                       lengths=A([5, 2], np.int32)),
    "fusion_seqexpand_concat_fc": Case(N(2, 4, 3, seed=364),
                                       [N(2, 2, seed=365)], N(5, 6, seed=366),
                                       N(6, seed=367), "tanh"),
    "fusion_seqpool_concat": Case([N(3, 4, 2, seed=368),
                                   N(3, 4, 3, seed=369)],
                                  A([4, 0, 2], np.int32), "SQRT"),
    "fusion_seqpool_cvm_concat": Case([F(3, 4, 3, seed=370, lo=0.0, hi=2.0)],
                                      A([4, 1, 2], np.int32), True, "SUM"),
    "fusion_squared_mat_sub": Case(X34, N(4, 5, seed=371), 0.5),
    "fusion_transpose_flatten_concat": Case([N(2, 3, 4, seed=372),
                                             N(2, 3, 5, seed=373)],
                                            (0, 2, 1), 1, 1),
    # --- vision
    "affine_grid": Case(N(2, 2, 3, seed=374), (2, 1, 4, 5)),
    "grid_sampler": Case(N(1, 2, 4, 5, seed=375),
                         F(1, 3, 3, 2, seed=376, lo=-1.2, hi=1.2)),
    "space_to_depth": Case(N(1, 2, 4, 6, seed=377), 2),
    "shuffle_channel": Case(N(1, 6, 2, 2, seed=378), 3),
    "temporal_shift": Case(N(6, 4, 2, 2, seed=379), 3, 0.25),
    "pool3d": Case(N(1, 2, 5, 5, 5, seed=380), 2, "max", 2, 1),
    "conv3d_transpose": Case(N(1, 2, 3, 3, 3, seed=381),
                             N(2, 3, 2, 2, 2, seed=382), 2, 1,
                             bias=N(3, seed=383)),
    "max_pool2d_with_index": Case(np.floor(N(1, 2, 6, 6, seed=384) * 1.5),
                                  2, 2),
    "unpool": Case(N(1, 2, 3, 3, seed=385), I(0, 36, 1, 2, 3, 3, seed=386),
                   (6, 6)),
    "spp": Case(N(1, 2, 4, 4, seed=387), 3, "max"),
    "data_norm": Case(N(3, 4, seed=388), F(4, seed=389, lo=1.0, hi=5.0),
                      N(4, seed=390), F(4, seed=391, lo=0.5, hi=4.0)),
    "deformable_conv": Case(N(1, 2, 5, 5, seed=392),
                            N(1, 18, 5, 5, seed=393),
                            N(3, 2, 3, 3, seed=394), 1, 1,
                            mask=F(1, 9, 5, 5, seed=395, lo=0.0, hi=1.0)),
    # --- graph
    "tree_conv": Case(N(2, 5, 3, seed=396), np.stack([
        _tree_coef([[1, 2], [1, 3], [2, 4], [2, 5]], 5, 3),
        _tree_coef([[1, 2], [2, 3], [0, 0], [0, 0]], 5, 3)])[:, 0],
        N(3, 3, 2, 4, seed=397)),
}

#: every registered name: an alias runs its target's case
ALIASES = {n: PREG.meta(n)["alias_of"] for n in PREG.list_ops()
           if "alias_of" in PREG.meta(n)}


def case_of(name):
    return CASES[ALIASES.get(name, name)]


# ------------------------------------------------------------ the name set

def test_name_set_is_the_references_less_what_is_still_to_port():
    jax_names, port_names = set(JREG.list_ops()), set(PREG.list_ops())
    assert port_names <= jax_names, sorted(port_names - jax_names)
    assert jax_names - port_names == STILL_TO_PORT
    for name in port_names:       # aliases name the reference's targets
        assert PREG.meta(name).get("alias_of") == \
            JREG.meta(name).get("alias_of"), name


def test_every_name_has_a_case():
    names = set(PREG.list_ops()) - {"nce_loss", "nce",
                                    "sampled_softmax_with_cross_entropy"}
    assert {ALIASES.get(n, n) for n in names} <= set(CASES)
    assert set(CASES) <= set(PREG.list_ops())


PARITY = sorted(set(PREG.list_ops()) - set(RANDOM)
                - {"nce_loss", "nce", "sampled_softmax_with_cross_entropy"})
DIFF = sorted(n for n in PARITY if n not in NON_DIFF)

#: the reference calls that do not trace under ``jax.jit`` (host numpy,
#: or shapes read from values): these run op by op
EAGER = {"chunk_eval", "generate_mask_labels", "mul", "sequence_concat",
         "sequence_erase", "sequence_slice", "sequence_unpad", "split",
         "poly2mask", "polys_to_mask_wrt_box", "sequence_reshape",
         "lod_append"}
#: the reference's results are computed for this many cases under one
#: ``jax.jit`` (a compile per case would cost most of this file's time)
GROUP = 48
_JAX = {}


def _float_slots(leaves):
    return [i for i, x in enumerate(leaves) if x.dtype.kind == "f"]


def _weights(name, out):
    """Fixed random weights of each float output (None elsewhere)."""
    rs = np.random.RandomState(7)
    return [None if o is None
            else np.asarray(rs.randn(*o.shape), np.float32)
            for o in _out_jax(out)]


def _grad_fn(name, targs, tkw, leaves, weights):
    fslots = _float_slots(leaves)

    def scalar(*fl):
        full = list(leaves)
        for i, v in zip(fslots, fl):
            full[i] = v
        out = _call_jax(name, targs, tkw, full)
        return sum((jnp.sum(o * jnp.asarray(w))
                    for o, w in zip(_out_jax(out), weights) if o is not None),
                   jnp.zeros((), jnp.float32))
    return lambda *arrs: jax.grad(scalar, tuple(range(len(fslots))))(
        *[arrs[i] for i in fslots])


def _group_run(kind, names):
    """The reference's forward outputs (``kind`` "fwd") or gradients
    ("grad") of ``names``, in one ``jax.jit``."""
    specs, flat = [], []
    for name in names:
        case, leaves, targs, tkw = _spec(name)
        specs.append((name, targs, tkw, len(flat), len(leaves)))
        flat += leaves

    def run(*arrs):
        res = {}
        for name, targs, tkw, off, k in specs:
            sub = list(arrs[off:off + k])
            if kind == "fwd":
                res[name] = _call_jax(name, targs, tkw, sub)
            else:
                res[name] = _grad_fn(name, targs, tkw, sub,
                                     jax_result("fwd", name)[1])(*sub)
        return res
    return jax.jit(run)(*[jnp.asarray(x) for x in flat])


def jax_result(kind, name):
    """(output, weights) for "fwd", the input gradients for "grad"."""
    key = (kind, name)
    if key not in _JAX:
        if name in EAGER:
            case, leaves, targs, tkw = _spec(name)
            arrs = [jnp.asarray(x) for x in leaves]
            if kind == "fwd":
                out = _call_jax(name, targs, tkw, arrs)
                _JAX[key] = (out, _weights(name, out))
            else:
                _JAX[key] = _grad_fn(name, targs, tkw, arrs,
                                     jax_result("fwd", name)[1])(*arrs)
        else:
            pool = [n for n in (PARITY if kind == "fwd" else DIFF)
                    if n not in EAGER]
            i = pool.index(name) // GROUP * GROUP
            group = pool[i:i + GROUP]
            res = _group_run(kind, group)
            for n in group:
                _JAX[(kind, n)] = ((res[n], _weights(n, res[n]))
                                   if kind == "fwd" else res[n])
    return _JAX[key]


@pytest.mark.parametrize("name", PARITY)
def test_parity(name):
    case = case_of(name)
    assert_same(run_port(name, case), jax_result("fwd", name)[0], case.tol)


@pytest.mark.parametrize("name", DIFF)
def test_gradient(name):
    """d(sum_i <w_i, out_i>)/d(every float input), the w_i fixed random
    weights of each float output."""
    case, leaves, targs, tkw = _spec(name)
    fslots = _float_slots(leaves)
    assert fslots, f"{name}: no float input to differentiate"
    arrs = [torch.from_numpy(np.array(x)) for x in leaves]
    for i in fslots:
        arrs[i].requires_grad_(True)
    out = PREG.get(name)(*_fill(targs, arrs, "port"),
                         **_fill(tkw, arrs, "port"), **case.port_kw)
    weights = jax_result("fwd", name)[1]
    outs = _out_tensors(out)
    assert len(outs) == len(weights)
    total = sum((o * torch.from_numpy(w)).sum()
                for o, w in zip(outs, weights) if w is not None)
    # an output built from the input's values alone (similarity_focus's
    # mask) carries no gradient, as the reference's carries zeros
    got = (torch.autograd.grad(total, [arrs[i] for i in fslots],
                               allow_unused=True) if total.requires_grad
           else [None] * len(fslots))
    for i, g, want in zip(fslots, got, jax_result("grad", name)):
        g = np.zeros(leaves[i].shape, np.float32) if g is None else g.numpy()
        np.testing.assert_allclose(g, np.asarray(want),
                                   err_msg=f"input {i}", **GRAD_TOL)


# ------------------------------------------------------------ random ops

def test_random_ops_shapes_ranges_moments_and_seeds():
    from paddle_tpu_torch.ops import tensor_ops as T
    g = lambda s: torch.Generator().manual_seed(s)  # noqa: E731
    u = T.uniform_random(g(0), [200, 100], min=-2.0, max=3.0)
    assert u.shape == (200, 100) and u.dtype == torch.float32
    assert float(u.min()) >= -2.0 and float(u.max()) < 3.0
    assert abs(float(u.mean()) - 0.5) < 0.05
    assert abs(float(u.var()) - 25.0 / 12) < 0.1
    n = T.gaussian_random(g(1), [200, 100], mean=1.0, std=2.0)
    assert abs(float(n.mean()) - 1.0) < 0.05
    assert abs(float(n.std()) - 2.0) < 0.05
    r = T.randint(g(2), 3, 11, [200, 100])
    assert r.dtype == torch.int32 and int(r.min()) == 3 and int(r.max()) == 10
    assert abs(float(r.float().mean()) - 6.5) < 0.05
    p = T.randperm(g(3), 50)
    assert sorted(p.tolist()) == list(range(50)) and p.dtype == torch.int32
    probs = torch.tensor([[0.1, 0.6, 0.3], [0.5, 0.0, 0.5]])
    m = T.multinomial(g(4), probs, 4000)
    assert m.shape == (2, 4000)
    freq = torch.stack([(m == c).float().mean(1) for c in range(3)], 1)
    np.testing.assert_allclose(freq.numpy(), probs.numpy(), atol=0.03)
    m2 = T.multinomial(g(5), torch.tensor([0.2, 0.3, 0.5]), 3,
                       replacement=False)
    assert sorted(m2.tolist()) == [0, 1, 2]
    for fn, args in ((T.uniform_random, ([5],)), (T.gaussian_random, ([5],)),
                     (T.randint, (0, 9, [5])), (T.randperm, (9,)),
                     (T.multinomial, (probs, 7))):
        torch.testing.assert_close(fn(g(11), *args), fn(g(11), *args))
        assert not torch.equal(fn(g(11), *args), fn(g(12), *args))
    # the reference's shapes and dtypes
    for name in RANDOM:
        case = CASES[name]
        got, want = run_port(name, case), run_jax(name, case)
        assert tuple(got.shape) == tuple(want.shape)
        assert got.is_floating_point() == jnp.issubdtype(want.dtype,
                                                         jnp.floating)


def test_dropout_masks_from_the_generator():
    from paddle_tpu_torch.ops import nn as NN
    x = torch.ones(400, 250)
    out = NN.dropout(x, torch.Generator().manual_seed(0), 0.3)
    kept = out != 0
    assert abs(float(kept.float().mean()) - 0.7) < 0.01
    torch.testing.assert_close(out[kept], torch.full_like(out[kept],
                                                          1 / 0.7))
    again = NN.dropout(x, torch.Generator().manual_seed(0), 0.3)
    torch.testing.assert_close(out, again)
    down = NN.dropout(x, torch.Generator().manual_seed(0), 0.3,
                      mode="downgrade_in_infer")
    assert set(down.unique().tolist()) == {0.0, 1.0}
    np.testing.assert_allclose(
        NN.dropout(x, None, 0.3, False, "downgrade_in_infer").numpy(), 0.7)


@pytest.mark.parametrize("alias", ["nce_loss", "nce"])
def test_nce_loss_on_the_references_draw(alias):
    b, d, c, k = 4, 3, 12, 5
    x, w, bias = N(b, d, seed=1), N(c, d, seed=2), N(c, seed=3)
    label = A([[3], [0], [11], [3]], np.int32)
    key = jax.random.key(44)
    want = JREG.get(alias)(key, *map(jnp.asarray, (x, label, w, bias)), c, k)
    neg = np.asarray(jax.random.randint(key, (b, k), 0, c))
    tx, tw = torch.from_numpy(x).requires_grad_(), \
        torch.from_numpy(w).requires_grad_()
    got = ploss.nce_loss_from(tx, torch.from_numpy(label), tw,
                              torch.from_numpy(bias), torch.from_numpy(neg), c)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    jg = jax.grad(lambda a, ww: JREG.get(alias)(
        key, a, jnp.asarray(label), ww, jnp.asarray(bias), c, k).sum(),
        argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    for g, j in zip(torch.autograd.grad(got.sum(), (tx, tw)), jg):
        np.testing.assert_allclose(g.numpy(), np.asarray(j), **GRAD_TOL)
    drawn = PREG.get(alias)(torch.Generator().manual_seed(0),
                            torch.from_numpy(x), torch.from_numpy(label),
                            torch.from_numpy(w), torch.from_numpy(bias), c, k)
    assert drawn.shape == (b, 1) and torch.isfinite(drawn).all()


def test_sampled_softmax_on_the_references_draw():
    b, d, c, s = 4, 3, 12, 6
    x, w, bias = N(b, d, seed=4), N(c, d, seed=5), N(c, seed=6)
    label = A([3, 0, 11, 5], np.int32)
    key = jax.random.key(9)
    name = "sampled_softmax_with_cross_entropy"
    want = JREG.get(name)(key, jnp.asarray(w), jnp.asarray(bias),
                          jnp.asarray(x), jnp.asarray(label), s, c)
    neg = np.asarray(jax.random.randint(key, (s,), 0, c))
    got = ploss.sampled_softmax_from(torch.from_numpy(w),
                                     torch.from_numpy(bias),
                                     torch.from_numpy(x),
                                     torch.from_numpy(label),
                                     torch.from_numpy(neg))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    drawn = PREG.get(name)(torch.Generator().manual_seed(0),
                           torch.from_numpy(w), torch.from_numpy(bias),
                           torch.from_numpy(x), torch.from_numpy(label), s, c)
    assert drawn.shape == (b, 1) and torch.isfinite(drawn).all()


# ------------------------------------------------------------ details

def test_creation_ops_default_to_the_card():
    """Built from nothing, a creation op goes to the card unless the CPU
    is asked for (or a ``placement`` block names it)."""
    from paddle_tpu_torch.core.enforce import EnforceError
    from paddle_tpu_torch.ops import tensor_ops as T
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(EnforceError):
        T.fill_constant([2], "float32", 1.0)
    with T.placement("cpu"):
        assert T.arange(4).device.type == "cpu"
        assert T.eye(2).device.type == "cpu"


def test_array_write_leaves_its_input():
    arr = torch.zeros(3, 2)
    out = PREG.get("array_write")(arr, 1, torch.ones(2))
    assert float(arr.abs().sum()) == 0.0 and float(out.sum()) == 2.0


def test_softmax_with_cross_entropy_soft_labels_on_another_axis():
    logits, label = N(2, 5, 3, seed=1), softmaxed(2, 3, 5, seed=2)
    label = np.ascontiguousarray(label.transpose(0, 2, 1))
    want = JREG.get("softmax_with_cross_entropy")(
        jnp.asarray(logits), jnp.asarray(label), True, axis=1)
    got = PREG.get("softmax_with_cross_entropy")(
        torch.from_numpy(logits), torch.from_numpy(label), True, axis=1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# ------------------------------------------------------------ the tail ops

def _both(name, *args, **kw):
    """``name`` through both registries on the same numpy arguments."""
    case = Case(*args, **kw)
    return run_port(name, case), run_jax(name, case)


def test_tail_random_ops_shapes_ranges_moments_and_seeds():
    g = lambda s: torch.Generator().manual_seed(s)  # noqa: E731
    probs = torch.tensor([[0.1, 0.6, 0.3, 0.0]]).expand(4000, 4)
    ids = ptail.sampling_id(probs, g(0))
    assert ids.shape == (4000,) and not ids.is_floating_point()
    freq = torch.bincount(ids, minlength=4).float() / 4000
    np.testing.assert_allclose(freq.numpy(), [0.1, 0.6, 0.3, 0.0],
                               atol=0.03)
    x = torch.arange(6 * 7 * 8, dtype=torch.float32).reshape(6, 7, 8)
    offsets = set()
    for s in range(40):
        c = ptail.random_crop(x, g(s), [3, 4, 8])
        assert c.shape == (3, 4, 8)
        i0, j0 = int(c[0, 0, 0]) // 56, int(c[0, 0, 0]) % 56 // 8
        torch.testing.assert_close(c, x[i0:i0 + 3, j0:j0 + 4])
        offsets.add((i0, j0))
    assert len(offsets) > 5 and max(o[0] for o in offsets) <= 3
    like = torch.zeros(300, 2)
    u = ptail.uniform_random_batch_size_like(like, g(1), [-1, 200],
                                             min=-2.0, max=1.0)
    assert u.shape == (300, 200) and u.dtype == torch.float32
    assert float(u.min()) >= -2.0 and float(u.max()) < 1.0
    assert abs(float(u.mean()) + 0.5) < 0.02
    n = ptail.gaussian_random_batch_size_like(like, g(2), [7, 200],
                                              mean=1.0, std=0.5,
                                              batch_dim=0)
    assert n.shape == (300, 200)
    assert abs(float(n.mean()) - 1.0) < 0.02
    assert abs(float(n.std()) - 0.5) < 0.02
    for fn, args in ((ptail.sampling_id, (probs,)),
                     (ptail.random_crop, (x, [3, 4, 5])),
                     (ptail.uniform_random_batch_size_like, (like, [-1, 9])),
                     (ptail.gaussian_random_batch_size_like,
                      (like, [-1, 9]))):
        a, b = args[0], args[1:]
        torch.testing.assert_close(fn(a, g(11), *b), fn(a, g(11), *b))
        assert not torch.equal(fn(a, g(11), *b), fn(a, g(12), *b))


def test_sample_logits_on_the_references_draw():
    rs = np.random.RandomState(3)
    n, k, t, ns = 5, 12, 2, 7
    logits = rs.randn(n, k).astype(np.float32)
    labels = rs.randint(0, k, (n, t)).astype(np.int32)
    key = jax.random.key(5)
    for hits in (True, False):
        want = JREG.get("sample_logits")(
            jnp.asarray(logits), jnp.asarray(labels), ns, key,
            remove_accidental_hits=hits)
        drawn = np.asarray(jax.random.randint(key, (n, ns), 0, k))
        samples = np.concatenate([labels, drawn], 1)
        got = ptail.sample_logits_from(
            torch.from_numpy(logits), torch.from_numpy(labels),
            torch.from_numpy(samples), torch.full((n, t + ns), 1.0 / k),
            remove_accidental_hits=hits)
        assert_same(got, want)
    out, lab = ptail.sample_logits(torch.from_numpy(logits),
                                   torch.from_numpy(labels), ns,
                                   torch.Generator().manual_seed(0))
    assert out.shape == (n, t + ns) and lab.shape == (n, t)


def test_hash_matches_the_reference_bit_for_bit_near_2_pow_32():
    """int32 ids across the whole range (uint32 values near 2**32 are the
    negative int32s) and int64 ids near 2**32 (their low 32 bits)."""
    ids = np.array([[2 ** 31 - 1, -1], [-2 ** 31, -2], [0, 1],
                    [123456789, -987654321]], np.int32)
    for mod_by, num_hash in ((1000, 3), (2 ** 31 - 1, 2), (7, 1)):
        got, want = _both("hash", ids, mod_by, num_hash)
        assert_same(got, want)
    near = np.array([[2 ** 32 - 1], [2 ** 32 - 2], [2 ** 32 - 12345]],
                    np.uint32)
    got = ptail.hash_bucket(torch.from_numpy(near.astype(np.int64)), 997, 2)
    want = JREG.get("hash")(jnp.asarray(near), 997, 2)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_max_pool2d_with_index_planted_ties():
    """Windows of equal values: the index is the reference's (the window's
    lowest), and the gradient goes to it."""
    x = np.zeros((1, 2, 4, 6), np.float32)
    x[0, 1, :2, :2] = 3.0
    x[0, 1, 2:, 2:4] = [[1.0, 5.0], [5.0, 5.0]]
    for args in ((2, 2), (3, 1, 1), ((2, 3), (2, 3))):
        got, want = _both("max_pool2d_with_index", x, *args)
        assert_same(got, want)
        xt = torch.from_numpy(x).requires_grad_()
        vals, _ = PREG.get("max_pool2d_with_index")(xt, *args)
        g, = torch.autograd.grad(vals.sum(), xt)
        jg = jax.grad(lambda a: JREG.get("max_pool2d_with_index")(
            a, *args)[0].sum())(jnp.asarray(x))
        np.testing.assert_array_equal(g.numpy(), np.asarray(jg))


def test_grid_sampler_and_deformable_conv_at_and_past_the_borders():
    img = N(2, 3, 4, 5, seed=11)
    grid = np.array([[-1.0, -1.0], [1.0, 1.0], [-1.0, 1.0], [1.0, -1.0],
                     [1.0, 0.3], [-1.0, -0.2], [1.25, 0.0], [0.0, -1.5],
                     [-1.1, 1.1], [0.999, -0.999]], np.float32)
    grid = np.broadcast_to(grid.reshape(1, 2, 5, 2), (2, 2, 5, 2)).copy()
    got, want = _both("grid_sampler", img, grid)
    assert_same(got, want)
    np.testing.assert_allclose(got[:, :, 0, 0].numpy(), img[:, :, 0, 0],
                               rtol=1e-6)
    np.testing.assert_allclose(got[:, :, 0, 1].numpy(), img[:, :, -1, -1],
                               rtol=1e-6)
    off = np.zeros((1, 18, 4, 4), np.float32)
    off[0, 0::2] = np.array([-1.0, 0.0, 1.0, 2.5, -2.0, 0.5, 3.0, -0.5,
                             1.0])[:, None, None]
    off[0, 1::2] = np.array([1.0, -1.0, 0.0, -2.5, 2.0, 4.0, 0.0, 1.5,
                             -1.0])[:, None, None]
    for pad, mask in ((0, None), (1, F(1, 9, 4, 4, seed=12, lo=0.0))):
        x = N(1, 2, 4 + 2 - 2 * pad, 4 + 2 - 2 * pad, seed=13)
        got, want = _both("deformable_conv", x, off, N(3, 2, 3, 3, seed=14),
                          1, pad, mask=mask)
        assert_same(got, want)


def test_tail_ops_beyond_the_cases():
    """Other modes and options of ops whose registry case takes one."""
    vol = N(1, 2, 5, 6, 5, seed=21)
    for kw in (dict(pool_type="avg", pool_stride=2, pool_padding=1),
               dict(pool_type="avg", pool_stride=2, pool_padding=1,
                    exclusive=False),
               dict(pool_type="max", pool_stride=2, ceil_mode=True),
               dict(pool_type="avg", pool_stride=2, ceil_mode=True)):
        assert_same(*_both("pool3d", vol, 3, **kw))
    assert_same(*_both("resize_trilinear", vol, size=(3, 8, 4),
                       align_corners=True))
    assert_same(*_both("resize_trilinear", vol, scale_factor=1.5))
    x, y = X34, POS
    for fl in (["elementwise_add", "scale"], ["relu", "elementwise_add"],
               ["scale", "elementwise_mul"]):
        assert_same(*_both("fused_elemwise_activation", x, y, fl, 0.5))
    assert_same(*_both("continuous_value_model", POS, False))
    assert_same(*_both("fused_fc_elementwise_layernorm", X234,
                       N(4, 5, seed=22), N(5, seed=23)))
    assert_same(*_both("conv3d_transpose", N(1, 4, 3, 2, 3, seed=24),
                       N(4, 3, 3, 2, 2, seed=25), (1, 2, 2), (1, 0, 1),
                       (1, 1, 2), 2))
    assert_same(*_both("image_resize_short", N(1, 5, 7, 2, seed=26), 4,
                       "NEAREST", "NHWC"))
    assert_same(*_both("tensor_array_to_tensor", X234, 1, False))
    assert_same(*_both("filter_by_instag", N(3, 2, seed=27),
                       A([[0, 0], [4, 0], [0, 9]], np.int32), [9]))
    assert_same(*_both("fusion_seqpool_concat", [N(2, 3, 2, seed=28)],
                       None, "AVERAGE"))
    assert_same(*_both("similarity_focus", N(1, 4, 3, 2, seed=29), 3, [1]))
    assert_same(*_both("spp", N(1, 2, 4, 4, seed=30), 2, "avg"))


def test_stateful_and_host_ops():
    from paddle_tpu_torch import initializer as PI
    from paddle_tpu_torch.core.enforce import EnforceError
    c = PREG.get("autoincreased_step_counter")(device="cpu")
    assert int(c) == 1 and c.dtype == torch.int32
    assert int(PREG.get("autoincreased_step_counter")(c)) == 2
    with pytest.raises(EnforceError):
        PREG.get("create_parameter")([2, 3], initializer=PI.normal(),
                                     device="cpu")
    p1 = PREG.get("create_parameter")([2, 3], initializer=PI.normal(),
                                      generator=torch.Generator()
                                      .manual_seed(4), device="cpu")
    p2 = PREG.get("create_parameter")([2, 3], initializer=PI.normal(),
                                      generator=torch.Generator()
                                      .manual_seed(4), device="cpu")
    assert p1.shape == (2, 3) and torch.equal(p1, p2)
    if not torch.cuda.is_available():
        for name, args in (("ones", ([2], "float32")),
                           ("create_tensor", ("float32", [2])),
                           ("create_global_var", ([2], 1.0))):
            with pytest.raises(EnforceError):
                PREG.get(name)(*args)
    out = PREG.get("py_func")(
        lambda a, b: (np.asarray(a) + b.sum(), np.asarray(a).argmax(-1)),
        torch.from_numpy(X34), torch.from_numpy(POS),
        out_shape_dtype=(ptail.ShapeDtype((3, 4), torch.float32),
                         ptail.ShapeDtype((3,), "int64")))
    np.testing.assert_allclose(out[0].numpy(), X34 + POS.sum(), rtol=1e-6)
    assert out[1].dtype == torch.int64
    with pytest.raises(EnforceError):
        PREG.get("py_func")(lambda a: np.asarray(a), torch.zeros(2),
                            out_shape_dtype=ptail.ShapeDtype((3,),
                                                             "float32"))
    arr = torch.ones(2)
    copied = PREG.get("assign")(arr)
    copied += 1
    assert float(arr.sum()) == 2.0


def test_tree_patch_coefficients_match_the_reference():
    from paddle_tpu.ops.graph import tree_patch_coefficients as jcoef
    from paddle_tpu_torch.ops.graph import tree_patch_coefficients as pcoef
    edges = [[[1, 2], [1, 3], [1, 4], [2, 5], [3, 6], [6, 7], [0, 0]],
             [[1, 2], [2, 3], [3, 4], [0, 0], [5, 6], [0, 0], [0, 0]]]
    for depth in (1, 2, 3, 5):
        np.testing.assert_array_equal(pcoef(edges, 8, depth),
                                      jcoef(edges, 8, depth))
