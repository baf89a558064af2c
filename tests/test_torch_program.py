"""The port's Program layer against the JAX package's, on the CPU: the op
registry's semantics, ``Program.capture`` / ``ops()`` / ``flop_estimate``,
``Executor.run`` (feeds, fetches, its cache, its errors, ``check_nan_inf``)
and ``ProgramDesc`` (JSON written by either package run by the other, the
reference's own desc tests replayed), then GPT's training loss as a
ProgramDesc (``chip_smoke.gpt_loss_desc``) at ``GPTConfig.tiny()``'s
width in both packages on the same feeds: the fetched loss within 1e-4
and every gradient within 1e-4 relative L2; and the same desc's loss
against the port's ``GPT.loss`` on the same weights (loaded through
``bridge.py``) within 1e-5.
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import chip_smoke as cs
import paddle_tpu  # noqa: F401  (fills the JAX registry)
from paddle_tpu.core import flags as jflags
from paddle_tpu.core.enforce import EnforceError as JEnforceError
from paddle_tpu.core.program import Program as JProgram
from paddle_tpu.core.program import flop_estimate as jflop_estimate
from paddle_tpu.static import Executor as JExecutor
from paddle_tpu.static import ProgramDesc as JProgramDesc
from paddle_tpu.static import program_desc as jprogram_desc
from paddle_tpu.static import program_from_fn as jprogram_from_fn
from paddle_tpu_torch.core.enforce import EnforceError
from paddle_tpu_torch.core.program import Program, flop_estimate
from paddle_tpu_torch.core.registry import GLOBAL_OP_REGISTRY, OpRegistry
from paddle_tpu_torch.static import (Executor, ProgramDesc, program_desc,
                                     program_from_fn)
from paddle_tpu_torch.static import program as sprogram

torch.set_num_threads(1)


def t(a):
    return torch.from_numpy(np.array(a))


def rand(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


# ------------------------------------------------------------ registry

def test_registry_refuses_a_duplicate_and_an_unknown_name():
    reg = OpRegistry()
    reg.register("double", lambda x: 2 * x, note="a")
    assert "double" in reg and reg.meta("double") == {"note": "a"}
    assert reg.list_ops() == ["double"]
    with pytest.raises(KeyError, match="already registered"):
        reg.register("double", lambda x: x)
    with pytest.raises(KeyError, match="not registered"):
        reg.get("triple")
    with pytest.raises(KeyError, match="already registered"):
        GLOBAL_OP_REGISTRY.register("relu", lambda x: x)
    with pytest.raises(KeyError, match="not registered"):
        GLOBAL_OP_REGISTRY.get("definitely_missing")

    @reg.register("inc")
    def inc(x):
        return x + 1
    assert reg.get("inc") is inc


# ------------------------------------------------------------ Program

def test_capture_lists_the_ops_and_their_avals():
    def fn(x, w):
        return torch.tanh(x @ w).sum(-1)
    x, w = rand(3, 4), rand(4, 5, seed=1)
    prog = Program.capture(fn, t(x), t(w))
    ops = prog.ops()
    assert "tanh" in ops and "mm" in ops and "sum" in ops
    assert prog.num_ops() == len(ops)
    assert [a.shape for a in prog.input_avals()] == [(3, 4), (4, 5)]
    assert prog.output_avals()[0].shape == (3,)
    assert prog.output_avals()[0].dtype == torch.float32
    jops = JProgram.capture(lambda a, b: jnp.tanh(a @ b).sum(-1),
                            jnp.asarray(x), jnp.asarray(w)).ops()
    assert "tanh" in jops
    np.testing.assert_allclose(prog(t(x), t(w)).numpy(),
                               np.asarray(jnp.tanh(x @ w).sum(-1)),
                               rtol=1e-5, atol=1e-5)
    assert prog.compile() is fn
    ep = prog.lower()
    assert isinstance(ep, torch.export.ExportedProgram)
    assert "tanh" in prog.to_text()


def test_flop_estimate_is_the_references_on_a_matmul():
    m, k, n = 6, 8, 5
    x, w = rand(m, k), rand(k, n, seed=1)
    got = flop_estimate(lambda a, b: a @ b, t(x), t(w))
    want = jflop_estimate(lambda a, b: a @ b, jnp.asarray(x), jnp.asarray(w))
    assert got == want == 2.0 * m * n * k


# ------------------------------------------------------------ Executor

def _both_programs():
    def pfn(x, w):
        return torch.tanh(x @ w), (x @ w).sum()

    def jfn(x, w):
        return jnp.tanh(x @ w), (x @ w).sum()
    return (program_from_fn(pfn, ["x", "w"], ["h", "s"]),
            jprogram_from_fn(jfn, ["x", "w"], ["h", "s"]))


def test_executor_feeds_fetches_and_reuses_its_cache():
    prog, jprog = _both_programs()
    exe, jexe = Executor("cpu"), JExecutor()
    x, w = rand(3, 4), rand(4, 2, seed=1)
    feed = {"x": x, "w": w}
    got = exe.run(prog, feed=feed, fetch_list=["s", "h"])
    want = jexe.run(jprog, feed=feed, fetch_list=["s", "h"])
    for g, j in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(j), rtol=1e-5,
                                   atol=1e-5)
    assert exe.cache_hits == 0 and len(exe._cache) == 1
    entry = next(iter(exe._cache.values()))
    exe.run(prog, feed={"x": rand(3, 4, seed=2), "w": w}, fetch_list=["s"])
    assert exe.cache_hits == 1 and len(exe._cache) == 1
    assert next(iter(exe._cache.values())) is entry
    exe.run(prog, feed={"x": rand(5, 4), "w": w}, fetch_list=["s"])
    assert len(exe._cache) == 2 == len(jexe._cache) + 1
    outs = exe.run(prog, feed=feed)
    assert isinstance(outs, tuple) and len(outs) == 2


def test_executor_places_on_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(EnforceError):
        Executor()


@pytest.mark.parametrize("fault", ["missing_feed", "output_count",
                                   "unknown_fetch"])
def test_executor_errors_as_the_reference_raises_them(fault):
    prog, jprog = _both_programs()
    feed = {"x": rand(3, 4), "w": rand(4, 2, seed=1)}
    if fault == "missing_feed":
        feed.pop("w")
        fetch = ["s"]
    elif fault == "output_count":
        prog.output_names, jprog.output_names = ["h"], ["h"]
        fetch = ["h"]
    else:
        fetch = ["nope"]
    with pytest.raises(EnforceError):
        Executor("cpu").run(prog, feed=feed, fetch_list=fetch)
    with pytest.raises(JEnforceError):
        JExecutor().run(jprog, feed=feed, fetch_list=fetch)


def test_check_nan_inf_raises_in_both_packages():
    prog = program_from_fn(lambda x: torch.log(x), ["x"], ["y"])
    jprog = jprogram_from_fn(lambda x: jnp.log(x), ["x"], ["y"])
    feed = {"x": np.array([1.0, -1.0], np.float32)}
    assert sprogram.configure()["check_nan_inf"] is False
    Executor("cpu").run(prog, feed=feed)              # off: no check
    saved = jflags.get_flag("check_nan_inf")
    try:
        sprogram.configure(check_nan_inf=True)
        jflags.set_flags({"check_nan_inf": True})
        with pytest.raises(EnforceError, match="check_nan_inf"):
            Executor("cpu").run(prog, feed=feed)
        with pytest.raises(JEnforceError):
            JExecutor().run(jprog, feed=feed)
    finally:
        sprogram.configure(check_nan_inf=False)
        jflags.set_flags({"check_nan_inf": saved})


def test_check_nan_inf_from_the_environment(tmp_path):
    import subprocess
    import sys
    code = ("from paddle_tpu_torch.static import program as p; "
            "print(p.configure()['check_nan_inf'])")
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        env={"PT_FLAGS_check_nan_inf": "1", "PATH": "/usr/bin:/bin",
             "PYTHONPATH": cs.__file__.rsplit("/", 1)[0]}, timeout=120)
    assert out.stdout.strip() == "True", out.stderr


# ------------------------------------------------------------ ProgramDesc

def _small_desc(make):
    desc = make(feeds=["x", "w", "b", "ids"], fetches=["out", "s", "top"])
    desc.append_op("fc", ["x", "w", "b"], ["h"], act="relu")
    desc.append_op("softmax", ["h"], ["out"], axis=-1)
    desc.append_op("reduce_sum", ["out"], ["s"], dim=[1])
    desc.append_op("embedding", ["ids", "w"], ["e"])
    desc.append_op("topk", ["e"], ["top", "where"], k=2)
    return desc


def _small_feeds():
    return {"x": rand(4, 8), "w": rand(8, 5, seed=1), "b": rand(5, seed=2),
            "ids": np.array([[1], [7], [0]], np.int32)}


def _run(desc, feeds, side):
    if side == "jax":
        return desc.build_fn()(*[jnp.asarray(feeds[n]) for n in desc.feeds])
    return desc.build_fn()(*[t(feeds[n]) for n in desc.feeds])


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_desc_json_written_by_one_package_runs_in_the_other(writer):
    make = jprogram_desc if writer == "jax" else program_desc
    text = _small_desc(make).to_json()
    doc = json.loads(text)
    assert doc["version"] == 1 and set(doc) == {"version", "feeds",
                                                "fetches", "ops"}
    port = ProgramDesc.parse_from_string(text)
    ref = JProgramDesc.parse_from_string(text)
    assert port.to_json() == ref.to_json() == text
    feeds = _small_feeds()
    got, want = _run(port, feeds, "port"), _run(ref, feeds, "jax")
    assert set(got) == set(want) == {"out", "s", "top"}
    for name in got:
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]),
                                   rtol=1e-5, atol=1e-5)


def test_reference_desc_build_serialize_parse_run():
    """``tests/test_amp_models_io.py`` ``TestProgramDesc``, in the port."""
    desc = program_desc(feeds=["x", "w"], fetches=["out", "s"])
    desc.append_op("fc", ["x", "w"], ["h"])
    desc.append_op("relu", ["h"], ["r"])
    desc.append_op("softmax", ["r"], ["out"])
    desc.append_op("reduce_sum", ["out"], ["s"])
    x = t(np.random.RandomState(0).rand(4, 8).astype(np.float32))
    w = t(np.random.RandomState(1).rand(8, 5).astype(np.float32))
    out1 = desc.build_fn()(x, w)
    parsed = ProgramDesc.parse_from_string(desc.to_json())
    out2 = parsed.build_fn()(x, w)
    np.testing.assert_allclose(out1["out"].numpy(), out2["out"].numpy(),
                               rtol=1e-6)
    np.testing.assert_allclose(float(out1["s"]), float(out2["s"]),
                               rtol=1e-6)
    wg = w.clone().requires_grad_()
    (g,) = torch.autograd.grad(parsed.build_fn()(x, wg)["s"].sum(), wg)
    assert g.shape == w.shape
    (fetched,) = Executor("cpu").run(parsed.to_static_program(),
                                     feed={"x": x, "w": w},
                                     fetch_list=["s"])
    np.testing.assert_allclose(float(fetched), float(out1["s"]), rtol=1e-6)


def test_reference_desc_unknown_op_rejected():
    desc = program_desc(["x"], ["y"])
    with pytest.raises(EnforceError, match="not registered"):
        desc.append_op("no_such_op", ["x"], ["y"])
    # every op of the reference is registered: one that was still to
    # port is taken like any other, and runs
    desc.append_op("fused_elemwise_activation", ["x", "x"], ["y"],
                   functor_list=["elementwise_add", "relu"])
    x = rand(2, 3)
    np.testing.assert_allclose(
        desc.build_fn()(t(x))["y"].numpy(), x + np.maximum(x, 0.0), rtol=1e-6)
    text = ('{"version": 1, "feeds": ["x"], "fetches": ["y"], '
            '"ops": [{"type": "definitely_missing", "inputs": ["x"], '
            '"outputs": ["y"]}]}')
    parsed = ProgramDesc.parse_from_string(text)
    with pytest.raises(EnforceError, match="not in the op registry"):
        parsed.build_fn()
    with pytest.raises(EnforceError, match="unsupported"):
        ProgramDesc.parse_from_string('{"version": 2, "feeds": [], '
                                      '"fetches": [], "ops": []}')
    bad = program_desc(["x"], ["y"])
    bad.append_op("relu", ["z"], ["y"])
    with pytest.raises(EnforceError, match="undefined var"):
        bad.build_fn()(t(rand(2)))


def test_reference_desc_alias_ops_resolve_in_programs():
    """``TestProgramDescRound3Ops`` with the aliases the port registers:
    the alias and its target give the same values."""
    desc = program_desc(feeds=["x", "ids"], fetches=["a", "b", "c", "d"])
    desc.append_op("embedding", ["ids", "x"], ["a"])
    desc.append_op("lookup_table", ["ids", "x"], ["b"])
    desc.append_op("range", [], ["c"], start=0, end=5, device="cpu")
    desc.append_op("Print", ["x"], ["d"], message="x: ")
    x = t(rand(6, 3))
    ids = t(np.array([4, 0, 5], np.int32))
    out = ProgramDesc.parse_from_string(desc.to_json()).build_fn()(x, ids)
    torch.testing.assert_close(out["a"], out["b"])
    assert out["c"].tolist() == [0, 1, 2, 3, 4]
    torch.testing.assert_close(out["d"], x)


# ------------------------------------------------------------ GPT desc

def _gpt_desc_and_feeds(seed=0, batch=2, seq=16):
    from paddle_tpu_torch.models.gpt import GPTConfig
    cfg = GPTConfig.tiny()
    shapes = cs.gpt_param_shapes(cfg.num_layers, cfg.hidden_size,
                                 cfg.intermediate_size, cfg.vocab_size,
                                 cfg.max_position)
    desc = cs.gpt_loss_desc(cfg.num_layers, cfg.num_heads, seq, shapes)
    feeds = cs.gpt_desc_feeds(np.random.RandomState(seed), shapes,
                              cfg.vocab_size, batch, seq)
    return desc, feeds


def _rel_l2(a, b, floor):
    """Relative L2, on a scale of at least ``floor``: the key bias's
    gradient is 0 in exact arithmetic (softmax ignores a shift that every
    key's score gets), so both sides hold rounding noise there."""
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), floor))


def test_gpt_desc_runs_alike_in_both_packages():
    desc, feeds = _gpt_desc_and_feeds()
    text = desc.to_json()
    jdesc = JProgramDesc.parse_from_string(text)
    jfn = jdesc.build_fn()
    names = jdesc.feeds
    floats = [n for n in names if feeds[n].dtype == np.float32]

    def jloss(*fl):
        env = {n: jnp.asarray(feeds[n]) for n in names}
        env.update(zip(floats, fl))
        return jfn(*[env[n] for n in names])["loss"]
    jl, jg = jax.jit(jax.value_and_grad(
        jloss, argnums=tuple(range(len(floats)))))(
        *[jnp.asarray(feeds[n]) for n in floats])
    (loss,) = Executor("cpu").run(
        ProgramDesc.parse_from_string(text).to_static_program(),
        feed=feeds, fetch_list=["loss"])
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-4, atol=1e-4)
    ploss, grads = cs.desc_loss_and_grads(desc, feeds, "cpu")
    np.testing.assert_allclose(float(ploss), float(loss), rtol=0, atol=0)
    assert set(grads) == set(floats)
    floor = 1e-3 * max(float(np.linalg.norm(g)) for g in jg)
    for name, g in zip(floats, jg):
        assert _rel_l2(grads[name].numpy(), np.asarray(g), floor) < 1e-4, \
            name


def test_gpt_desc_loss_is_gpt_loss_on_the_same_weights():
    """The desc's loss against the port's ``GPT.loss``: the JAX GPT's
    weights loaded into the port's model through ``bridge.load_params``,
    then fed to the desc under the port's parameter names."""
    from paddle_tpu.models.gpt import GPT as JGPT
    from paddle_tpu.models.gpt import GPTConfig as JConfig
    from paddle_tpu_torch import bridge
    from paddle_tpu_torch.models.gpt import GPT, GPTConfig
    jcfg = JConfig.tiny()
    jcfg.dropout = 0.0
    variables = JGPT(jcfg).init(jax.random.key(3))
    cfg = GPTConfig.tiny()
    cfg.dropout = 0.0
    model = GPT(cfg, device="cpu", seed=9).eval()
    bridge.load_params(model, jax.tree_util.tree_map(np.asarray,
                                                     variables["params"]))
    desc, feeds = _gpt_desc_and_feeds(seed=4)
    for name, p in model.named_parameters():
        feeds[name] = p.detach().numpy().copy()
    (loss,) = Executor("cpu").run(desc.to_static_program(), feed=feeds,
                                  fetch_list=["loss"])
    want = model.loss(t(feeds["ids"]))
    np.testing.assert_allclose(float(loss), float(want), rtol=1e-5,
                               atol=1e-5)
