"""The port's export (``paddle_tpu_torch/io/inference.py``, the kernels'
``torch.library`` ops, the engine's AOT hooks) against the JAX package's
(``paddle_tpu/io/inference.py``, ``paddle_tpu/serving/engine.py``), on the
CPU at small sizes.

* every kernel is an op ``paddle_tpu_torch::<name>`` whose fake
  implementation returns the plain version's shapes and dtypes on fake
  CUDA tensors (no card here);
* the PTPB archive byte for byte against the JAX writer;
* ``GPTConfig.tiny()``'s logits through save/load: the loaded CPU program
  bitwise the port's eager output, within 1e-4 of the JAX
  ``load_inference_model`` output (the whole-model bar), ``params.bin``
  byte for byte the JAX export's, and a process that imports only
  ``paddle_tpu_torch.io`` runs the program;
* ``save_train_program`` on ``tests/test_native.py:104``'s SGD problem:
  the JAX signature, and 20 loaded steps within 1e-5 of the JAX
  program's;
* ``export_decode`` (``tests/test_serving.py:325``): the loaded step's
  tokens equal the engine's next token and the JAX exported step's;
* the card path's paged-decode graph contract (the counterpart of
  ``tests/test_compile_smoke.py:56``): one K7 op per layer and no
  ``[S, Pmax, H, ps, hd]`` gathered K/V, with the CPU program's gather as
  the positive control;
* the CPU programs of ``compiled_decode`` (a greedy and a sampled row)
  and ``compiled_verify`` give the engine's draws and the eager verify's.
"""

import collections
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
STEP_TOL = dict(rtol=1e-5, atol=1e-5)
OPS = ("layer_norm", "add_layer_norm", "flash_attention",
       "flash_attention_bwd_dq", "flash_attention_bwd_dkv", "mlp",
       "xent_stats", "xent_bwd_dh", "xent_bwd_dwb", "decode_attention")


def _read_json(path):
    with open(path) as f:
        return json.load(f)


def _fake_cuda(*ts):
    from paddle_tpu_torch.io.inference import _fake_cuda
    return _fake_cuda(ts)


def _meta_of(outs):
    outs = outs if isinstance(outs, (tuple, list)) else (outs,)
    return [(tuple(t.shape), t.dtype) for t in outs]


# ------------------------------------------------------------- the ops

def _op_cases(name, dtype, rs):
    """``(wrapper on the fake CUDA copies, plain version on the CPU
    tensors, CPU tensors)`` of op ``name``."""
    from paddle_tpu_torch.ops.cuda import decode_attention as da
    from paddle_tpu_torch.ops.cuda import flash_attention as fa
    from paddle_tpu_torch.ops.cuda import layer_norm as ln
    from paddle_tpu_torch.ops.cuda import mlp
    from paddle_tpu_torch.ops.cuda import xent

    def t(*shape, dt=dtype):
        return torch.from_numpy(rs.randn(*shape).astype(np.float32)).to(dt)

    f32 = torch.float32
    if name in ("layer_norm", "add_layer_norm"):
        x, h, g, b = t(6, 40), t(6, 40), t(40), t(40)
        if name == "layer_norm":
            return (lambda *a: ln.layer_norm_kernel(*a, 1e-5),
                    lambda *a: ln.layer_norm_plain(*a, 1e-5), (x, g, b))
        return (lambda *a: ln.add_layer_norm_kernel(*a, 1e-5),
                lambda *a: ln.add_layer_norm_plain(*a, 1e-5), (x, h, g, b))
    if name.startswith("flash"):
        q, k, v = t(2, 2, 5, 16), t(2, 2, 7, 16), t(2, 2, 7, 16)
        mask = torch.from_numpy(rs.rand(2, 7) > 0.3)
        if name == "flash_attention":
            return (lambda q, k, v, m: fa.flash_attention_kernel(
                        q, k, v, 0.25, True, m),
                    lambda q, k, v, m: fa.chunked_attention(
                        q, k, v, 0.25, True, m, return_lse=True),
                    (q, k, v, mask))
        out, lse = fa.chunked_attention(q, k, v, 0.25, True, mask,
                                        return_lse=True)
        do = t(2, 2, 5, 16)
        delta = (do.float() * out.float()).sum(-1)
        wrap = (fa.flash_attention_bwd_dq_kernel
                if name.endswith("dq") else fa.flash_attention_bwd_dkv_kernel)
        pick = slice(0, 1) if name.endswith("dq") else slice(1, 3)
        return (lambda q, k, v, do, lse, delta, m: wrap(
                    q, k, v, do, lse, delta, 0.25, True, m),
                lambda q, k, v, do, lse, delta, m:
                fa.flash_attention_bwd_plain(q, k, v, out, lse, do, 0.25,
                                             True, m)[pick],
                (q, k, v, do, lse, delta, mask))
    if name == "mlp":
        return (mlp.mlp_kernel, mlp.mlp_plain,
                (t(5, 16), t(16, 24), t(24), t(24, 8), t(8)))
    if name.startswith("xent"):
        h, w, b = t(6, 16), t(50, 16), t(50, dt=f32)
        labels = torch.from_numpy(rs.randint(0, 50, 6))
        if name == "xent_stats":
            return (xent.xent_stats_kernel, xent.xent_stats_plain,
                    (h, w, b, labels))
        logz, g = t(6, dt=f32), t(6, dt=f32)
        wrap = (xent.xent_bwd_dh_kernel if name.endswith("dh")
                else xent.xent_bwd_dwb_kernel)
        pick = slice(0, 1) if name.endswith("dh") else slice(1, 3)
        return (lambda *a: wrap(*a, 0.01, 0.9),
                lambda *a: xent.xent_bwd_plain(*a, 0.01, 0.9)[pick],
                (h, w, b, labels, logz, g))
    # decode_attention: f32 queries over f32/bf16 pools, or int8 pools
    # with their scales
    pool_dt = torch.int8 if dtype == torch.bfloat16 else f32
    kp = t(9, 2, 4, 8, dt=f32).to(pool_dt)
    vp = t(9, 2, 4, 8, dt=f32).to(pool_dt)
    scales = ((t(9, 4, dt=f32).abs(), t(9, 4, dt=f32).abs())
              if pool_dt == torch.int8 else (None, None))
    table = torch.from_numpy(rs.randint(0, 9, (3, 3)).astype(np.int32))
    lengths = torch.tensor([5, 0, 12], dtype=torch.int32)
    return (lambda q, kp, vp, tb, ln_, ks, vs: da.paged_decode_kernel(
                q, kp, vp, tb, ln_, 0.3, ks, vs),
            lambda q, kp, vp, tb, ln_, ks, vs: da.paged_attention_plain(
                q, kp, vp, tb, ln_, 0.3, ks, vs),
            (t(3, 2, 8, dt=f32), kp, vp, table, lengths, *scales))


@pytest.mark.parametrize("name", OPS)
def test_op_is_registered_and_its_fake_matches_the_plain_version(name):
    from paddle_tpu_torch.ops.cuda import core
    kernel = core.KERNELS[name]
    op = getattr(torch.ops.paddle_tpu_torch, name).default
    assert kernel.op is op
    assert op.name() == f"paddle_tpu_torch::{name}"
    # each op names the TPU kernel it replaces: a Pallas kernel function of
    # a file that reaches kernel_call
    path, line = kernel.replaces.rsplit(":", 1)
    with open(os.path.join(REPO, path)) as f:
        src = f.read()
    assert "kernel_call(" in src
    assert src.splitlines()[int(line) - 1].startswith("def _")
    assert all(not a.alias_info for a in op._schema.arguments)  # no writes
    rs = np.random.RandomState(3)
    for dtype in (torch.float32, torch.bfloat16):
        wrapper, plain, args = _op_cases(name, dtype, rs)
        fake = [a if a is None else _fake_cuda(a)[0] for a in args]
        got = wrapper(*fake)
        outs = got if isinstance(got, tuple) else (got,)
        assert all(o.device.type == "cuda" for o in outs)
        assert _meta_of(got) == _meta_of(plain(*args)), (name, dtype)


def test_device_rule_calls_the_op_on_fake_cuda_tensors(monkeypatch):
    """The wrappers take the op (not the plain version) for CUDA tensors,
    fake ones included, and never for CPU tensors."""
    from paddle_tpu_torch.ops.cuda import layer_norm as ln
    calls = []
    real = ln.LAYER_NORM_OP
    monkeypatch.setattr(ln, "LAYER_NORM_OP",
                        lambda *a: calls.append(1) or real(*a))
    x, g = torch.randn(4, 8), torch.randn(8)
    ln.layer_norm_rows(x, g, g)
    assert calls == []
    ln.layer_norm_rows(*_fake_cuda(x, g, g))
    assert calls == [1]


@pytest.mark.parametrize("index", [
    (slice(1, None),), (0,), (slice(None), 2), (None, Ellipsis, 1),
    (torch.tensor([2, 0]),), (slice(None), torch.tensor([1, 1, 0])),
    (torch.tensor([1, 0]), slice(None), torch.tensor([3, 2])),
    (Ellipsis, torch.tensor(1)), ([0, 2],)])
def test_card_methods_index_as_python_does(index):
    """The fake-CUDA trace's indexing (aten ops) gives Python's result,
    read and write, on real tensors."""
    from paddle_tpu_torch.io import inference as inf
    x = torch.arange(3 * 4 * 5, dtype=torch.float32).reshape(3, 4, 5)
    torch.testing.assert_close(inf._getitem(x, index), x[index],
                               rtol=0, atol=0)
    a, b = x.clone(), x.clone()
    value = -torch.ones_like(x[index])
    a[index] = value
    inf._setitem(b, index, value)
    torch.testing.assert_close(b, a, rtol=0, atol=0)
    assert inf._to(x, torch.bfloat16).dtype == torch.bfloat16
    assert inf._to(x, "cpu") is x


# ------------------------------------------------------- the PTPB archive

def test_params_bin_is_byte_exact_with_the_jax_writer(tmp_path, rng):
    from paddle_tpu.io import inference as J
    from paddle_tpu_torch.io import inference as P
    arrays = [rng.randn(3, 5).astype(np.float32),
              np.asarray(jnp.asarray(rng.randn(4, 2), jnp.bfloat16)),
              rng.randint(-128, 127, (7,)).astype(np.int8),
              rng.randint(0, 1000, (2, 3)).astype(np.int32),
              rng.rand(5) > 0.5, np.float32(2.5), np.int64(7),
              rng.randn(2).astype(np.float16)]
    J._write_params_bin(str(tmp_path / "j.bin"), arrays)
    P._write_params_bin(str(tmp_path / "p.bin"), arrays)
    tensors = [P.as_tensor(a) for a in arrays]
    P._write_params_bin(str(tmp_path / "t.bin"), tensors)
    jbytes = (tmp_path / "j.bin").read_bytes()
    assert (tmp_path / "p.bin").read_bytes() == jbytes
    assert (tmp_path / "t.bin").read_bytes() == jbytes
    for reader in (J.read_params_bin, P.read_params_bin):
        back = reader(str(tmp_path / "t.bin"))
        assert len(back) == len(arrays)
        for got, want in zip(back, arrays):
            np.testing.assert_array_equal(
                got, np.asarray(want).astype(got.dtype))


# ----------------------------------------------- the inference round trip

def _gpt_pair():
    from paddle_tpu.models.gpt import GPTConfig, GPT
    from paddle_tpu_torch import bridge
    from paddle_tpu_torch.models.gpt import GPT as PGPT
    from paddle_tpu_torch.models.gpt import GPTConfig as PConfig
    cfg = GPTConfig.tiny()
    cfg.dropout = 0.0
    jm = GPT(cfg)
    v = jm.init(jax.random.key(0))
    pcfg = PConfig.tiny()
    pcfg.dropout = 0.0
    pm = PGPT(pcfg, device="cpu", seed=1).eval()
    bridge.load_params(pm, jax.tree_util.tree_map(np.asarray, v["params"]))
    return jm, v, pm


def test_inference_model_round_trips_against_jax(tmp_path):
    from paddle_tpu.io import inference as J
    from paddle_tpu_torch import bridge
    from paddle_tpu_torch.io import inference as P
    jm, v, pm = _gpt_pair()
    ids = np.random.RandomState(5).randint(0, 512, (2, 16)).astype(np.int32)

    def jfwd(p, x):
        return jm.apply({"params": p, "state": {}}, x)

    def pfwd(p, x):
        return P.call_with_params(pm, p, lambda m, x: m(x), x)

    jpath, ppath = str(tmp_path / "jax"), str(tmp_path / "port")
    J.save_inference_model(jpath, jfwd, (jnp.asarray(ids),), v["params"])
    P.save_inference_model(ppath, pfwd, (torch.from_numpy(ids),),
                           bridge.param_tree(pm))
    got = P.load_inference_model(ppath, device="cpu")(torch.from_numpy(ids))
    with torch.no_grad():
        eager = pm(torch.from_numpy(ids))
    assert torch.equal(got, eager)                       # bitwise
    want = np.asarray(J.load_inference_model(jpath)(jnp.asarray(ids)))
    np.testing.assert_allclose(got.numpy(), want, **LOGIT_TOL)
    # the flat order is the JAX package's: the same bytes for the C++
    # predictor (no leaf of either tree lacks a counterpart)
    with open(os.path.join(ppath, "params.bin"), "rb") as f, \
            open(os.path.join(jpath, "params.bin"), "rb") as g:
        assert f.read() == g.read()
    jsig = _read_json(os.path.join(jpath, "signature.json"))
    psig = _read_json(os.path.join(ppath, "signature.json"))
    for key in ("mode", "num_params", "treedef"):
        assert psig[key] == jsig[key], key
    assert [i["shape"] for i in psig["inputs"]] == \
        [i["shape"] for i in jsig["inputs"]]
    assert P.read_params_bin(os.path.join(ppath, "inputs.bin"))[0].tolist() \
        == ids.tolist()
    _, flat, sig = P.load_inference_model(ppath, raw=True, device="cpu")
    assert len(flat) == sig["num_params"] == len(jax.tree_util.tree_leaves(
        v["params"]))
    # the card's program holds the kernels' ops: 2 layer norms a block and
    # ln_f, one flash attention and one fused MLP a block
    ep = P.load_exported(ppath, "cuda")
    ops = collections.Counter(str(n.target) for n in ep.graph.nodes
                              if "paddle_tpu_torch" in str(n.target))
    assert ops == {"paddle_tpu_torch.layer_norm.default": 5,
                   "paddle_tpu_torch.flash_attention.default": 2,
                   "paddle_tpu_torch.mlp.default": 2}
    # a process that imports only paddle_tpu_torch.io loads and runs it
    code = (
        "import sys, numpy as np, torch\n"
        "import paddle_tpu_torch.io as io\n"
        f"pred = io.load_inference_model({ppath!r}, device='cpu')\n"
        f"x = io.read_params_bin({os.path.join(ppath, 'inputs.bin')!r})[0]\n"
        "out = pred(torch.from_numpy(np.array(x)))\n"
        f"np.save({str(tmp_path / 'out.npy')!r}, out.numpy())\n"
        "bad = [m for m in sys.modules if m.split('.')[:2] in ("
        "['paddle_tpu_torch', 'models'], ['paddle_tpu_torch', 'nn'], "
        "['paddle_tpu_torch', 'serving']) or m.split('.')[0] in "
        "('jax', 'paddle_tpu')]\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    np.testing.assert_array_equal(np.load(tmp_path / "out.npy"),
                                  eager.numpy())


def test_predictor_runs_fn_over_params():
    from paddle_tpu_torch import bridge
    from paddle_tpu_torch.io import Predictor
    from paddle_tpu_torch.io.inference import call_with_params
    _, _, pm = _gpt_pair()
    ids = torch.from_numpy(np.random.RandomState(6).randint(0, 512, (1, 8)))
    pred = Predictor(lambda p, x: call_with_params(pm, p, lambda m, x: m(x),
                                                   x), bridge.param_tree(pm))
    with torch.no_grad():
        torch.testing.assert_close(pred(ids), pm(ids), rtol=0, atol=0)


# ------------------------------------------------------- the train program

def test_train_program_matches_jax(tmp_path):
    """tests/test_native.py:104's SGD least squares: the same signature,
    and 20 steps of each loaded program, state fed back, within 1e-5."""
    import paddle_tpu as pt
    from paddle_tpu.io import inference as J
    from paddle_tpu_torch.io import inference as P
    rs = np.random.RandomState(0)
    X = rs.randn(32, 4).astype(np.float32)
    y = X @ np.array([1.0, -2.0, 0.5, 3.0], np.float32)

    opt = pt.optimizer.SGD(0.1)
    jparams = {"w": jnp.zeros((4,))}
    jstate = {"params": jparams, "opt": opt.init(jparams)}

    def jstep(state, X, y):
        def loss_fn(p):
            return jnp.mean((X @ p["w"] - y) ** 2), None
        loss, p, o, _ = opt.minimize(loss_fn, state["params"], state["opt"])
        return loss, {"params": p, "opt": o}

    pstate = {"params": {"w": torch.zeros(4)},
              "opt": {"step": torch.zeros((), dtype=torch.int32),
                      "slots": {"w": {}}}}

    def pstep(state, X, y):
        w = state["params"]["w"].detach().requires_grad_(True)
        with torch.enable_grad():
            loss = torch.mean((X @ w - y) ** 2)
            (g,) = torch.autograd.grad(loss, w)
        return loss.detach(), {
            "params": {"w": (w - 0.1 * g).detach()},
            "opt": {"step": state["opt"]["step"] + 1,
                    "slots": state["opt"]["slots"]}}

    jpath, ppath = str(tmp_path / "jax"), str(tmp_path / "port")
    J.save_train_program(jpath, jstep, jstate, (jnp.asarray(X),
                                                jnp.asarray(y)))
    P.save_train_program(ppath, pstep, pstate, (torch.from_numpy(X),
                                                torch.from_numpy(y)))
    jsig = _read_json(os.path.join(jpath, "signature.json"))
    psig = _read_json(os.path.join(ppath, "signature.json"))
    for key in ("mode", "num_params", "feedback", "treedef", "inputs"):
        assert psig[key] == jsig[key], key
    assert psig["inplace"] == []
    jprog = J.load_program(jpath)
    pprog = P.load_program(ppath, device="cpu")
    n = psig["num_params"]
    jflat = jax.tree_util.tree_leaves(jstate)
    pflat = [torch.from_numpy(np.array(a)) for a in P.read_params_bin(
        os.path.join(ppath, "params.bin"))]
    pflat = [t.to(getattr(torch, s["dtype"]))
             for t, s in zip(pflat, psig["params"])]
    losses = []
    for _ in range(20):
        jout = jprog(*jflat, jnp.asarray(X), jnp.asarray(y))
        pout = pprog(*pflat, torch.from_numpy(X), torch.from_numpy(y))
        losses.append(float(pout[0]))
        np.testing.assert_allclose(float(pout[0]), float(jout[0]),
                                   **STEP_TOL)
        jflat = [jout[1 + j] for j in range(n)]
        pflat = [pout[1 + j] for j in range(n)]
        for got, want in zip(pflat, jflat):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       **STEP_TOL)
    assert losses[-1] < 0.1 * losses[0]              # it trains


# --------------------------------------------------- the engine's hooks

def _engines(draft=False):
    from paddle_tpu.models.gpt import GPTConfig, GPTDecoder
    from paddle_tpu.serving import ServeConfig, ServingEngine
    from paddle_tpu_torch import bridge
    from paddle_tpu_torch.models.gpt import GPTConfig as PConfig
    from paddle_tpu_torch.models.gpt import GPTDecoder as PDecoder
    from paddle_tpu_torch.serving.engine import ServeConfig as PServe
    from paddle_tpu_torch.serving.engine import ServingEngine as PEngine
    cfg = GPTConfig.tiny()
    cfg.dropout = 0.0
    cfg.use_flash = False
    jm = GPTDecoder(cfg)
    v = jm.init(jax.random.key(0))
    pcfg = PConfig.tiny()
    pcfg.dropout = 0.0
    pm = PDecoder(pcfg, device="cpu", seed=1)
    bridge.load_params(pm, jax.tree_util.tree_map(np.asarray, v["params"]))
    kw = dict(num_slots=2, page_size=8, max_len=24, prefill_len=8)
    return (ServingEngine(jm, v, ServeConfig(**kw)),
            PEngine(pm, PServe(**kw, draft=draft, spec_k=2)))


def test_export_decode_round_trips_against_the_engine_and_jax(tmp_path):
    from paddle_tpu.io.inference import load_program as jload
    from paddle_tpu_torch.io import inference as P
    jeng, peng = _engines()
    prompt = np.random.RandomState(0).randint(0, 512, (5,)).astype(np.int32)
    for eng in (jeng, peng):
        eng.submit(prompt, max_new=6)
        eng.step()                     # live pools, one running slot
    np.testing.assert_array_equal(peng._page_table, jeng._page_table)
    path = peng.export_decode(str(tmp_path / "serve"))
    sig = _read_json(os.path.join(path, "signature.json"))
    n = sig["num_params"]
    assert sig["mode"] == "train" and sig["feedback"] == [
        [1 + j, j] for j in range(n)]
    # the pools (every leaf after the params) are written in place
    n_params = len(list(peng._model.parameters()))
    assert sig["inplace"] == list(range(n_params, n))
    from paddle_tpu_torch import bridge
    state = [t.detach().clone() for t in P.tree_flatten(
        (bridge.param_tree(peng._model), peng._caches))[0]]
    batch = [torch.from_numpy(a.copy()) for a in (
        peng._last_tokens, peng._page_table, peng._lengths, peng._active)]
    out = P.load_program(path, device="cpu")(*state, *batch)
    toks = out[0]
    assert toks.shape == (2,) and toks.dtype == torch.int32
    # the outputs paired with the pools are those same tensors, written
    for j in sig["inplace"]:
        assert out[1 + j] is state[j]
    jpath = jeng.export_decode(str(tmp_path / "jax"))
    jout = jload(jpath)(*jax.tree_util.tree_leaves(
        (jeng._params, jeng._caches)), jeng._last_tokens.copy(),
        jeng._page_table.copy(), jeng._lengths.copy(),
        jeng._active.copy())
    slot = next(iter(peng._running))
    np.testing.assert_array_equal(toks.numpy()[slot],
                                  np.asarray(jout[0])[slot])
    req = peng._running[slot]
    peng.step()
    assert req.tokens[-1] == int(toks[slot])


def _lattice_nodes(ep, s, pmax, h, ps, hd):
    """Nodes whose value is a gathered ``[S, Pmax, H, ps, hd]`` K/V
    lattice."""
    want = (s, pmax, h, ps, hd)
    return [n for n in ep.graph.nodes
            if isinstance(n.meta.get("val"), torch.Tensor)
            and tuple(n.meta["val"].shape) == want]


def _op_counts(ep):
    return collections.Counter(
        str(n.target).split(".")[1] for n in ep.graph.nodes
        if str(n.target).startswith("paddle_tpu_torch."))


def test_compiled_decode_graph_contract_on_fake_cuda():
    """The card path's decode step: one K7 op per layer, K1 twice a layer
    and once for ln_f, K4 once a layer, and no dense gathered K/V; the
    CPU program (the plain version's gather) trips the same detector."""
    _, peng = _engines(draft=True)
    cfg = peng._model.cfg
    layers = cfg.num_layers
    dims = (peng.cfg.num_slots, peng._page_table.shape[1], cfg.num_heads,
            peng.cfg.page_size, cfg.hidden_size // cfg.num_heads)
    card = peng.compiled_decode(device="cuda")
    assert _op_counts(card) == {"decode_attention": layers,
                                "layer_norm": 2 * layers + 1,
                                "mlp": layers}
    assert _lattice_nodes(card, *dims) == []
    placeholders = [n for n in card.graph.nodes if n.op == "placeholder"]
    assert all(n.meta["val"].device.type == "cuda" for n in placeholders)
    cpu = peng.compiled_decode(device="cpu")
    assert _op_counts(cpu) == {}
    assert _lattice_nodes(cpu, *dims)                  # positive control
    # the verify: the continuation branch (no flash launch), K1 and K4
    verify = peng.compiled_verify(device="cuda")
    assert _op_counts(verify) == {"layer_norm": 2 * layers + 1,
                                  "mlp": layers}


def _clone_pools(caches):
    return [{k: v.clone() for k, v in pool.items()} for pool in caches]


def test_compiled_decode_program_draws_the_engines_tokens():
    """The CPU program of compiled_decode, run on a live engine's state
    and knobs (a greedy request and a sampled one), draws the tokens the
    engine's next step draws: the greedy row its argmax, the sampled row
    its Philox draw."""
    from paddle_tpu_torch import bridge
    from paddle_tpu_torch.io import inference as P
    _, peng = _engines()
    rs = np.random.RandomState(2)
    # lengths 6 and 4 after admission: the next step takes no page (the
    # program is given the page table as it stands)
    peng.submit(rs.randint(0, 512, (5,)).astype(np.int32), max_new=6)
    peng.submit(rs.randint(0, 512, (3,)).astype(np.int32), max_new=6,
                temperature=0.8, top_k=20, seed=7)
    while peng._queue:
        peng.step()
    assert sorted(peng._running) == [0, 1]
    table = peng._page_table.copy()
    ep = peng.compiled_decode(device="cpu")
    args = (bridge.param_tree(peng._model), _clone_pools(peng._caches),
            peng._last_tokens, peng._page_table, peng._lengths,
            peng._active, *peng._knob_arrays())
    got = ep.module()(*[P.as_tensor(a) for a in P.tree_flatten(args)[0]])
    before = {s: len(r.tokens) for s, r in peng._running.items()}
    reqs = dict(peng._running)
    peng.step()
    np.testing.assert_array_equal(peng._page_table, table)
    assert (peng._temps > 0).sum() == 1                 # one row sampled
    for slot, req in reqs.items():
        assert req.tokens[before[slot]] == int(got[0][slot]), slot


def test_compiled_verify_program_matches_the_eager_verify():
    """The CPU program of compiled_verify gives the draws of the eager
    verify (``paged_verify_chunk`` on the continuation branch, then each
    position's head and greedy draw) on the same live state, bitwise."""
    from paddle_tpu_torch import bridge
    from paddle_tpu_torch.io import inference as P
    _, peng = _engines(draft=True)
    rs = np.random.RandomState(3)
    for n in (5, 9):
        peng.submit(rs.randint(0, 512, (n,)).astype(np.int32), max_new=8)
    while peng._queue:
        peng.step()
    s, w = peng.cfg.num_slots, peng.cfg.spec_k + 1
    window = rs.randint(0, 512, (s, w)).astype(np.int32)
    starts = np.maximum(peng._lengths, 1).astype(np.int32)
    wins = np.full(s, w, np.int32)
    ep = peng.compiled_verify(device="cpu")
    args = (bridge.param_tree(peng._model), _clone_pools(peng._caches),
            window, starts, wins, peng._page_table, *peng._knob_arrays())
    got = ep.module()(*[P.as_tensor(a) for a in P.tree_flatten(args)[0]])[0]
    model = peng._model
    with torch.no_grad():
        hidden, _ = model.paged_verify_chunk(
            torch.from_numpy(window), torch.from_numpy(starts),
            torch.from_numpy(wins), _clone_pools(peng._caches),
            torch.from_numpy(peng._page_table), chunked=[True] * s)
        want = torch.stack([torch.argmax(model.verify_head(hidden[:, i]),
                                         dim=-1) for i in range(w)], dim=1)
    assert got.shape == (s, w)
    assert torch.equal(got, want)
