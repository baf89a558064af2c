"""The PyTorch port's NMT Transformer against the JAX reference, on the CPU.

The same inputs, made with numpy from a seed, go through the JAX function
and its counterpart in the port (the plain versions of the kernels, since
the tensors lie on the CPU); the weights are the JAX model's, bridged.
Where the JAX function reaches a Pallas kernel (the fused add + layer norm,
K8), it runs in interpret mode as well as on its XLA path.

The model is ``TransformerConfig.tiny()`` (vocab 1000, d 64, 4 heads, FFN
128, 2 + 2 layers) at B = 2, a source of 12 with row 1 padded after 7
tokens (``src_mask``) and a target of 10 with pad ids in ``tgt_out``.

Tolerances (f32): 1e-5 per op (sums in another order); the loss within
1e-5 and logits within 1e-4; gradients within 1e-4 abs + rel (two layers
of products and the vocab head compound the per-op rounding). Under the
bf16 policy both packages compute in f32 with bf16 weights and round the
gradients to bf16 at the same places: the loss within 1e-5, the
gradients within 1e-2 relative L2 (a gradient element that lies near a
bf16 rounding boundary may round the other way, 2^-8 of itself).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.core.flags import all_flags, set_flags

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)
B, S, T = 2, 12, 10
PAD = 0


@pytest.fixture
def flags_guard():
    saved = all_flags()
    yield
    set_flags(saved)


def _mode(mode):
    if mode == "interpret":
        set_flags({"pallas_interpret": True})


def t(a):
    return torch.from_numpy(np.array(np.asarray(a)))


def n(x):
    return x.detach().float().numpy()


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _flat(tree):
    from paddle_tpu_torch import bridge
    return bridge.flatten(_np_tree(tree))


def _pair(seed=0, **over):
    """(jax model, jax params, port model) with identical weights."""
    from paddle_tpu.models.transformer import Transformer as JM
    from paddle_tpu.models.transformer import TransformerConfig as JC
    from paddle_tpu_torch import bridge
    from paddle_tpu_torch.models.transformer import Transformer as PM
    from paddle_tpu_torch.models.transformer import TransformerConfig as PC
    kw = dict(dataclass_fields(JC.tiny()), dropout=0.0, **over)
    jm = JM(JC(**kw))
    params = jm.init(jax.random.key(seed))["params"]
    pm = PM(PC(**kw), device="cpu", seed=seed + 7)
    bridge.load_params(pm, _np_tree(params))
    return jm, params, pm


def dataclass_fields(cfg):
    import dataclasses
    return dataclasses.asdict(cfg)


def _batch(rng, vocab=1000):
    """(src, tgt_in, tgt_out, src_mask) as numpy arrays: row 1's source
    padded after 7 tokens, pad ids at the end of both target rows."""
    src = rng.randint(1, vocab, (B, S)).astype(np.int32)
    src_mask = np.ones((B, S), np.float32)
    src_mask[1, 7:] = 0.0
    src[1, 7:] = PAD
    tgt_in = rng.randint(1, vocab, (B, T)).astype(np.int32)
    tgt_out = rng.randint(1, vocab, (B, T)).astype(np.int32)
    tgt_out[0, 8:] = PAD
    tgt_out[1, 5:] = PAD
    return src, tgt_in, tgt_out, src_mask


def _apply(jm, params, method, *args, **kw):
    return jm.apply({"params": params, "state": {}}, *map(jnp.asarray, args),
                    method=method, **kw)


# -------------------------------------------------------------- pieces

@pytest.mark.parametrize("max_len,d_model", [(32, 64), (10, 16), (256, 64)])
def test_positional_encoding_matches_jax(max_len, d_model):
    """Concatenated [sin | cos] halves, not interleaved."""
    from paddle_tpu.models.transformer import positional_encoding as jpe
    from paddle_tpu_torch.models.transformer import positional_encoding
    got = positional_encoding(max_len, d_model)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(n(got), np.asarray(jpe(max_len, d_model)),
                               **TOL)
    np.testing.assert_array_equal(n(got[0]), np.r_[np.zeros(d_model // 2),
                                                   np.ones(d_model // 2)])


def test_soft_label_softmax_with_cross_entropy_matches_jax(rng):
    from paddle_tpu.ops.loss import softmax_with_cross_entropy as jax_swce
    from paddle_tpu_torch.ops.loss import softmax_with_cross_entropy
    logits = (rng.randn(3, 4, 50) * 3).astype(np.float32)
    label = rng.rand(3, 4, 50).astype(np.float32)
    label /= label.sum(-1, keepdims=True)
    want = jax_swce(jnp.asarray(logits), jnp.asarray(label), soft_label=True)
    got = softmax_with_cross_entropy(t(logits), t(label), soft_label=True)
    assert tuple(got.shape) == (3, 4, 1)
    np.testing.assert_allclose(n(got), np.asarray(want), **TOL)
    hard = rng.randint(0, 50, (3, 4)).astype(np.int32)
    np.testing.assert_allclose(
        n(softmax_with_cross_entropy(t(logits), t(hard))),
        np.asarray(jax_swce(jnp.asarray(logits), jnp.asarray(hard))), **TOL)


def test_relu_and_sigmoid_match_jax(rng):
    from paddle_tpu.ops import activations as JA
    from paddle_tpu_torch.ops import activations as A
    x = rng.randn(4, 33).astype(np.float32) * 4
    for name in ("relu", "sigmoid"):
        np.testing.assert_allclose(
            n(getattr(A, name)(t(x))),
            np.asarray(getattr(JA, name)(jnp.asarray(x))), err_msg=name,
            **TOL)


def test_matmul_promotes_as_jnp_and_leaves_one_dtype_alone(rng):
    from paddle_tpu_torch.ops.nn import matmul
    a = t(rng.randn(3, 8).astype(np.float32))
    w = t(rng.randn(8, 5).astype(np.float32)).to(torch.bfloat16)
    got = matmul(a, w)
    want = jnp.asarray(np.asarray(a)) @ jnp.asarray(
        w.float().numpy()).astype(jnp.bfloat16)
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    np.testing.assert_allclose(n(got), np.asarray(want), **TOL)
    wb = matmul(a.to(torch.bfloat16), w)
    assert wb.dtype == torch.bfloat16
    torch.testing.assert_close(wb, a.to(torch.bfloat16) @ w, rtol=0, atol=0)


@pytest.mark.parametrize("mode", ["xla", "interpret"])
@pytest.mark.parametrize("shape", [(13, 48), (2, 5, 64)])
def test_add_layer_norm_f32_rows_bf16_params_match_jax(rng, flags_guard,
                                                        mode, shape):
    """K8's plain version with f32 x/h and bf16 scale/bias, as the bf16
    policy's Transformer calls it: y f32 as JAX's, the gradients of x and
    h in f32 and of the scale and bias in bf16 (as JAX returns them)."""
    from paddle_tpu.ops.pallas.layer_norm import add_layer_norm_fused
    from paddle_tpu_torch.ops.cuda.layer_norm import (
        add_layer_norm_fused as port_aln)
    c = shape[-1]
    x = (rng.randn(*shape) * 3 + 1).astype(np.float32)
    h = rng.randn(*shape).astype(np.float32)
    g = (rng.randn(c) * 0.1 + 1).astype(np.float32)
    b = (rng.randn(c) * 0.1).astype(np.float32)
    dy = rng.randn(*shape).astype(np.float32)
    axis = len(shape) - 1
    gb, bb = (jnp.asarray(a).astype(jnp.bfloat16) for a in (g, b))
    _mode(mode)
    y, vjp = jax.vjp(lambda a, o, s, e: add_layer_norm_fused(
        a, o, s, e, begin_norm_axis=axis), jnp.asarray(x), jnp.asarray(h),
        gb, bb)
    assert y.dtype == jnp.float32
    leaves = [t(x).requires_grad_(True), t(h).requires_grad_(True),
              t(g).to(torch.bfloat16).requires_grad_(True),
              t(b).to(torch.bfloat16).requires_grad_(True)]
    py = port_aln(*leaves, begin_norm_axis=axis)
    assert py.dtype == torch.float32
    np.testing.assert_allclose(n(py), np.asarray(y), **TOL)
    py.backward(t(dy))
    for name, g_, w_ in zip(("dx", "dh", "dscale", "dbias"), leaves,
                            vjp(jnp.asarray(dy))):
        assert g_.grad.dtype == g_.dtype, name
        assert str(w_.dtype) == str(g_.dtype).replace("torch.", ""), name
        tol = TOL if g_.dtype == torch.float32 else dict(rtol=2 ** -7,
                                                         atol=1e-5)
        np.testing.assert_allclose(n(g_.grad), np.asarray(w_).astype(
            np.float32), err_msg=name, **tol)


@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("causal,tk", [(False, 7), (False, 13), (True, 9)])
def test_cross_attention_matches_jax(rng, bias, causal, tk):
    """``multihead_attention(kv=)``: k and v from kv of another length
    (Tq = 9), a key-padding mask ``[B, 1, 1, Tk]``, optional biases; and
    causal self-attention (kv None) with the mask. Output and
    gradients."""
    from paddle_tpu.ops.attention import multihead_attention as jax_mha
    from paddle_tpu_torch.ops import attention as att
    e, tq = 32, 9
    self_attn = causal
    tk = tq if self_attn else tk
    x = rng.randn(B, tq, e).astype(np.float32)
    kv = rng.randn(B, tk, e).astype(np.float32)
    ws = [(rng.randn(e, e) * 0.2).astype(np.float32) for _ in range(4)]
    bs = ([(rng.randn(e) * 0.1).astype(np.float32) for _ in range(4)]
          if bias else [None] * 4)
    mask = np.ones((B, 1, 1, tk), np.float32)
    mask[1, ..., tk - 3:] = 0.0
    dy = rng.randn(B, tq, e).astype(np.float32)
    jb = [None if a is None else jnp.asarray(a) for a in bs]

    def jf(xx, kk, wq, wk):
        return jax_mha(xx, wq, wk, *map(jnp.asarray, ws[2:]), *jb,
                       num_heads=4, mask=jnp.asarray(mask), causal=causal,
                       kv=None if self_attn else kk)

    y, vjp = jax.vjp(jf, *map(jnp.asarray, (x, kv, ws[0], ws[1])))
    leaves = [t(a).requires_grad_(True) for a in (x, kv, ws[0], ws[1])]
    py = att.multihead_attention(
        leaves[0], leaves[2], leaves[3], *map(t, ws[2:]),
        *[None if a is None else t(a) for a in bs], 4, mask=t(mask),
        causal=causal, kv=None if self_attn else leaves[1])
    np.testing.assert_allclose(n(py), np.asarray(y), **TOL)
    py.backward(t(dy))
    grads = vjp(jnp.asarray(dy))
    for name, g_, w_ in zip(("x", "kv", "wq", "wk"), leaves, grads):
        if self_attn and name == "kv":
            continue
        np.testing.assert_allclose(n(g_.grad), np.asarray(w_), err_msg=name,
                                   **TOL)


def _xent_inputs(rng, rows=21, hid=16, vocab=100):
    h = rng.randn(rows, hid).astype(np.float32)
    w = (rng.randn(hid, vocab) * 0.3).astype(np.float32)
    b = (rng.randn(vocab) * 0.1).astype(np.float32)
    labels = rng.randint(0, vocab, rows).astype(np.int32)
    g = rng.rand(rows).astype(np.float32)
    return h, w, b, labels, g


@pytest.mark.parametrize("wdtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_bias", [True, False])
@pytest.mark.parametrize("ls,chunk", [(0.1, 48), (0.0, 48), (0.1, 100),
                                      (0.1, 8192)])
def test_fused_xent_hv_matches_jax(rng, wdtype, with_bias, ls, chunk):
    """The hv layout: a vocab of 100 in chunks of 48 (48, 48 and a ragged
    4), one chunk, and the default 8192; f32 h against an f32 or bf16
    weight (the bf16 policy's f32 · bf16); the loss and the gradients of
    h, W and b in their own dtypes."""
    from paddle_tpu.ops.fused import fused_xent as jax_fx
    from paddle_tpu_torch.ops.fused import fused_xent
    h, w, b, labels, g = _xent_inputs(rng)
    jw = jnp.asarray(w).astype(wdtype)
    args = [jnp.asarray(h), jw] + ([jnp.asarray(b)] if with_bias else [])

    def jf(hh, ww, *bb):
        return jax_fx(hh, ww, jnp.asarray(labels),
                      bias=bb[0] if bb else None, weight_layout="hv",
                      label_smoothing=ls, chunk=chunk)

    y, grads = jax.jit(lambda *a: (lambda out: (out[0], out[1](
        jnp.asarray(g))))(jax.vjp(jf, *a)))(*args)
    tw = t(w).to(getattr(torch, wdtype))
    leaves = [t(h).requires_grad_(True), tw.requires_grad_(True)] + (
        [t(b).requires_grad_(True)] if with_bias else [])
    py = fused_xent(leaves[0], leaves[1], t(labels),
                    bias=leaves[2] if with_bias else None,
                    weight_layout="hv", label_smoothing=ls,
                    chunk=None if chunk == 8192 else chunk)
    assert py.dtype == torch.float32
    np.testing.assert_allclose(n(py), np.asarray(y), **TOL)
    py.backward(t(g))
    for name, g_, w_ in zip(("dh", "dw", "db"), leaves, grads):
        assert g_.grad.dtype == g_.dtype, name
        tol = TOL if g_.dtype == torch.float32 else dict(rtol=2 ** -7,
                                                         atol=1e-6)
        np.testing.assert_allclose(n(g_.grad), np.asarray(w_).astype(
            np.float32), err_msg=name, **tol)


def test_fused_xent_refuses_what_is_not_ported(rng):
    from paddle_tpu_torch.ops.fused import fused_xent
    h, w, _, labels, _ = _xent_inputs(rng)
    with pytest.raises(NotImplementedError):
        fused_xent(t(h), t(w), t(labels), weight_layout="hv",
                   vocab_axis="tp")
    with pytest.raises(ValueError):
        fused_xent(t(h), t(w), t(labels), weight_layout="vhh")


# --------------------------------------------------------------- model

def test_transformer_encode_decode_forward_match_jax(rng):
    jm, params, pm = _pair()
    src, tgt_in, _, src_mask = _batch(rng)
    mem, hid, logits = jax.jit(lambda p: (
        _apply(jm, p, "encode", src, src_mask),
        _apply(jm, p, lambda s, ti, m: jm.decode_hidden(
            ti, jm.encode(s, m), m), src, tgt_in, src_mask),
        _apply(jm, p, "forward", src, tgt_in, src_mask)))(params)
    with torch.no_grad():
        pmem = pm.encode(t(src), t(src_mask))
        phid = pm.decode_hidden(t(tgt_in), pmem, t(src_mask))
        plog = pm(t(src), t(tgt_in), t(src_mask))
    np.testing.assert_allclose(n(pmem), np.asarray(mem), **TOL)
    np.testing.assert_allclose(n(phid), np.asarray(hid), **TOL)
    np.testing.assert_allclose(n(plog), np.asarray(logits), **LOGIT_TOL)
    # the padded source keys change nothing: row 1 with other pad ids
    src2 = src.copy()
    src2[1, 7:] = 5
    with torch.no_grad():
        np.testing.assert_allclose(
            n(pm(t(src2), t(tgt_in), t(src_mask))[1]), n(plog[1]),
            **LOGIT_TOL)


@pytest.mark.parametrize("mode", ["xla", "interpret"])
@pytest.mark.parametrize("ls", [0.1, 0.0])
def test_transformer_loss_and_grads_match_jax(rng, flags_guard, mode, ls):
    """``Transformer.loss`` (the fused hv cross-entropy, pads masked,
    label smoothing ``ls``) and every parameter's gradient against JAX's;
    the port's ``nmt_loss`` of the logits against JAX's and against the
    fused loss."""
    from paddle_tpu.models.transformer import nmt_loss as jax_nmt
    from paddle_tpu_torch.models.transformer import nmt_loss
    jm, params, pm = _pair()
    src, tgt_in, tgt_out, src_mask = _batch(rng)
    _mode(mode)
    jl, jg = jax.jit(jax.value_and_grad(lambda p: _apply(
        jm, p, "loss", src, tgt_in, tgt_out, src_mask,
        label_smoothing=ls)))(params)
    pl = pm.loss(t(src), t(tgt_in), t(tgt_out), t(src_mask),
                 label_smoothing=ls)
    pl.backward()
    np.testing.assert_allclose(pl.item(), float(jl), **TOL)
    want = _flat(jg)
    got = {name: p.grad for name, p in pm.named_parameters()}
    assert sorted(got) == sorted(want)
    for name, g_ in got.items():
        np.testing.assert_allclose(n(g_), want[name], err_msg=name,
                                   **GRAD_TOL)
    jn = jax.jit(lambda p: jax_nmt(_apply(
        jm, p, "forward", src, tgt_in, src_mask), jnp.asarray(tgt_out), PAD,
        ls))(params)
    with torch.no_grad():
        pn = nmt_loss(pm(t(src), t(tgt_in), t(src_mask)), t(tgt_out), PAD,
                      ls)
    np.testing.assert_allclose(float(pn), float(jn), **TOL)
    np.testing.assert_allclose(float(pn), pl.item(), **TOL)


def test_transformer_bf16_policy_adam_step_matches_jax(rng):
    """One step of ``amp.decorate(Adam, bf16_policy())`` on both sides.
    The reference computes in f32 under the policy (the f32 positional
    encoding promotes the bf16 embedding, and f32 · bf16 products are
    f32): the activations are f32 on both sides, the loss agrees as in
    f32, and the updated parameters within Adam's step."""
    import paddle_tpu as pt
    from paddle_tpu_torch import amp, bridge
    from paddle_tpu_torch.optimizer import Adam
    jm, params, pm = _pair()
    src, tgt_in, tgt_out, src_mask = _batch(rng)
    policy = pt.amp.bf16_policy()
    jmem = jax.jit(lambda p: _apply(jm, policy.cast_to_compute(p),
                                    "encode", src))(params)
    assert jmem.dtype == jnp.float32
    cast = {k: v.to(torch.bfloat16) for k, v in pm.state_dict().items()}
    with torch.no_grad():
        pmem = torch.func.functional_call(
            _Encode(pm), {"m." + k: v for k, v in cast.items()}, (t(src),))
    assert pmem.dtype == torch.float32
    np.testing.assert_allclose(n(pmem), np.asarray(jmem), **TOL)

    lr = 1e-3
    jopt = pt.amp.decorate(pt.optimizer.Adam(lr), policy)
    jstate = jopt.init(params)

    def jloss(p, *a):
        return jm.apply({"params": p, "state": {}}, *a, method="loss"), 0.0

    jargs = tuple(map(jnp.asarray, (src, tgt_in, tgt_out, src_mask)))
    jl, jp, jstate, _ = jax.jit(lambda p, st: jopt.minimize(
        jloss, p, st, *jargs))(params, jstate)
    popt = amp.decorate(Adam(pm.parameters(), lr), amp.bf16_policy())
    pl = popt.minimize(pm, lambda m, *a: m.loss(*a),
                       *map(t, (src, tgt_in, tgt_out, src_mask)))
    np.testing.assert_allclose(float(pl), float(jl), **TOL)
    assert all(p.dtype == torch.float32 for p in pm.parameters())
    want_p = _flat(jp)
    for name, p in pm.named_parameters():
        np.testing.assert_allclose(n(p), want_p[name], rtol=0, atol=2 * lr,
                                   err_msg=name)
    # the gradients the step took, on the f32 masters (bf16-rounded)
    jg = jax.jit(jax.grad(lambda p: jloss(policy.cast_to_compute(p),
                                          *policy.cast_to_compute(jargs))[
        0].astype(jnp.float32)))(params)
    want = _flat(jg)
    got = {name: n(p.grad) for name, p in pm.named_parameters()}
    diff = sum(float(((got[k] - want[k].astype(np.float32)) ** 2).sum())
               for k in want)
    norm = sum(float((want[k].astype(np.float32) ** 2).sum()) for k in want)
    assert (diff / norm) ** 0.5 <= 1e-2
    assert int(bridge.export_opt_state(popt, pm)["inner"]["step"]) == 1


class _Encode(torch.nn.Module):
    def __init__(self, m):
        super().__init__()
        self.m = m

    def forward(self, src):
        return self.m.encode(src)


def test_transformer_refuses_what_is_not_ported():
    from paddle_tpu_torch import bridge
    from paddle_tpu_torch.models.transformer import (Transformer,
                                                     TransformerConfig)
    m = Transformer(TransformerConfig.tiny(), device="cpu")
    ids = torch.ones(1, 4, dtype=torch.long)
    for kw in (dict(vocab_axis="tp"), dict(mesh="m"), dict(mesh_plan="p")):
        with pytest.raises(NotImplementedError):
            m.loss(ids, ids, ids, **kw)
    tree = bridge.export_params(m)
    tree["out_proj"]["weight_q"] = np.zeros((64, 1000), np.int8)
    with pytest.raises(KeyError):          # an int8 weight without its scale
        bridge.load_params(m, tree)


def test_transformer_bridge_round_trip_names_match_jax():
    from paddle_tpu.models.transformer import Transformer as JM
    from paddle_tpu.models.transformer import TransformerConfig as JC
    from paddle_tpu_torch import bridge
    from paddle_tpu_torch.models.transformer import (Transformer,
                                                     TransformerConfig)
    want = _flat(JM(JC.tiny()).init(jax.random.key(0))["params"])
    pm = Transformer(TransformerConfig.tiny(), device="cpu", seed=3)
    got = bridge.flatten(bridge.export_params(pm))
    assert sorted(got) == sorted(want)
    assert all(got[k].shape == want[k].shape for k in want)
