"""Inference and train-step export of the port — the counterpart of
``paddle_tpu/io/inference.py`` (save/load of an inference model, the
state-feedback train program, the PTPB tensor archive of the C++
predictor, and the in-process ``Predictor``).

The JAX package lowers ``fn(params, *inputs)`` to StableHLO and writes one
``jax.export`` artifact for cpu and tpu together. The port's twin is
``torch.export``: :func:`save_inference_model` writes two programs of the
same flat signature,

* ``model.cpu.pt2``: traced on CPU tensors, so every kernel wrapper takes
  its plain PyTorch version (aten ops only);
* ``model.cuda.pt2``: traced on the card path, on real CUDA tensors where
  there is a card and on fake CUDA tensors where there is none. It holds
  the kernels' ops (``torch.ops.paddle_tpu_torch.*``, ``ops/cuda/core.py
  define_op``), whose fake implementations trace without a device.

and beside them ``params.npz``, ``params.bin`` and ``inputs.bin`` (the
PTPB archive, byte for byte the JAX package's format) and
``signature.json`` with the JAX keys (``mode``, ``inputs``,
``num_params``, ``treedef``) and the port's own: ``params`` (each flat
leaf's shape and dtype, with which ``params.npz``'s bf16 leaves, stored
widened to f32, are restored) and ``paths``.

**The flat order** is the JAX package's tree-flatten order: dict keys
sorted at every level, lists and tuples in order, ``None`` no leaf. A
port param tree in the JAX layout (``bridge.param_tree``) therefore
flattens to the JAX package's leaves one for one, and the same bridged
weights give the same ``params.bin`` bytes. ``treedef`` is rendered as
``str`` of a JAX ``PyTreeDef`` renders it.

Every program is traced with ``make_fx`` (which records the backward of
``torch.autograd.grad`` and of the kernels' ``autograd.Function``\\s as
aten ops) and then exported with ``torch.export``: ``torch.export`` of a
step that calls ``torch.func`` fails on this torch, ``make_fx`` does not.
In-place writes (the serving pools' ``paged_write``) stay in place in the
program: ``signature.json``'s ``inplace`` lists the flat inputs the
program writes, and the program returns those same tensors.

Where there is no card, the few Tensor methods whose Python bindings take
a CUDA device guard (indexing, ``to`` and the dtype casts,
``contiguous``, ``copy_``) cannot run on a fake CUDA tensor in a
CPU-only build, so the card trace routes them through the aten ops they
call (:func:`_card_methods`): the graph is the one a card would record.
A card never takes that route.
"""

import contextlib
import json
import os
import struct

import numpy as np
import torch
from torch.fx.experimental.proxy_tensor import make_fx

# the kernels' ops: a program of the card path names them, and loading it
# needs them registered (no model code is imported)
import paddle_tpu_torch.ops.cuda  # noqa: F401
from paddle_tpu_torch import bridge
from paddle_tpu_torch.core.device import resolve_device
from paddle_tpu_torch.core.enforce import EnforceError, enforce

# ------------------------------------------------------------ pytrees


def tree_flatten(tree):
    """``(leaves, paths)`` of a nested dict/list/tuple in the JAX
    package's tree-flatten order (dict keys sorted; ``None`` holds no
    leaf); paths join keys with ``/``."""
    leaves, paths = [], []

    def walk(node, path):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], path + (str(k),))
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, path + (str(i),))
        elif node is not None:
            leaves.append(node)
            paths.append("/".join(path))

    walk(tree, ())
    return leaves, paths


def tree_unflatten(like, leaves):
    """``like``'s structure with its leaves replaced, in
    :func:`tree_flatten` order, by ``leaves``."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            out = {k: None for k in node}
            for k in sorted(node):
                out[k] = build(node[k])
            return out
        if isinstance(node, (list, tuple)):
            return type(node)(build(v) for v in node)
        return None if node is None else next(it)

    out = build(like)
    enforce(next(it, None) is None, "tree_unflatten: leaves left over")
    return out


def treedef_str(tree):
    """The structure of ``tree`` as ``str`` of a JAX ``PyTreeDef``
    renders it, e.g. ``PyTreeDef({'b': [*, *], 'w': *})``."""
    def render(node):
        if isinstance(node, dict):
            return "{" + ", ".join(f"{k!r}: {render(node[k])}"
                                   for k in sorted(node)) + "}"
        if isinstance(node, list):
            return "[" + ", ".join(render(v) for v in node) + "]"
        if isinstance(node, tuple):
            inner = ", ".join(render(v) for v in node)
            return "(" + inner + ("," if len(node) == 1 else "") + ")"
        return "None" if node is None else "*"

    return f"PyTreeDef({render(tree)})"


def _out_leaves(out):
    """A program's outputs as a flat tuple (a lone tensor stays one)."""
    if isinstance(out, torch.Tensor):
        return (out,)
    return tuple(tree_flatten(out)[0])


# ------------------------------------------------------------ tensors

def as_tensor(x):
    """A leaf as a detached torch tensor: numpy arrays (bf16 through f32,
    exactly, as the bridge converts them), scalars, or tensors."""
    return bridge._to_torch(x).detach()


def _to_numpy(t):
    """A leaf as numpy for ``params.npz`` (bf16 widened to f32)."""
    return bridge._to_numpy(as_tensor(t))


def _dtype_name(t):
    return str(t.dtype).replace("torch.", "")


def _spec(t):
    return {"shape": list(t.shape), "dtype": _dtype_name(t)}


def _from_spec(arr, spec, device):
    """A ``params.npz`` array back in its recorded dtype on ``device``."""
    return torch.from_numpy(np.array(arr)).to(
        device=device, dtype=getattr(torch, spec["dtype"]))


# ------------------------------------------------- tracing and export

def _fake_cuda(leaves):
    """Fake CUDA copies of ``leaves`` (shapes and dtypes, no data) under
    one ``FakeTensorMode``: what the card path is traced on where there
    is no card."""
    from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode
    mode = FakeTensorMode(allow_non_fake_inputs=True)
    cuda = torch.device("cuda", 0)
    return [FakeTensor(mode, t.to("meta"), cuda) for t in leaves]


def _index_parts(x, index):
    """The basic part of a Python index applied with aten ops, as
    Python's indexing applies it: ``(view, advanced)``, where ``advanced``
    lists each remaining dim's index tensor (``None`` for a dim taken
    whole), or is None when the index has no tensor."""
    index = index if isinstance(index, tuple) else (index,)
    if any(isinstance(i, torch.Tensor) and i.dtype == torch.bool
           for i in index):
        raise NotImplementedError("boolean-mask indexing of a fake CUDA "
                                  "tensor")
    named = sum(1 for i in index if i is not None and i is not Ellipsis)
    out, dim, adv = x, 0, []
    for i in index:
        if i is Ellipsis:
            rest = x.dim() - named
            adv += [None] * rest
            dim += rest
        elif i is None:
            out = out.unsqueeze(dim)
            adv.append(None)
            dim += 1
        elif isinstance(i, slice):
            if i != slice(None):
                out = torch.ops.aten.slice.Tensor(out, dim, i.start, i.stop,
                                                  i.step or 1)
            adv.append(None)
            dim += 1
        elif isinstance(i, (torch.Tensor, list)):
            adv.append(torch.as_tensor(i, device=x.device))
            dim += 1
        else:
            out = out.select(dim, i)
    if not any(isinstance(a, torch.Tensor) for a in adv):
        return out, None
    while adv[-1] is None:
        adv.pop()
    return out, adv


def _to(self, *args, **kwargs):
    """``Tensor.to`` of a fake CUDA tensor through ``aten._to_copy``."""
    dtype, device = kwargs.get("dtype"), kwargs.get("device")
    for a in args:
        if isinstance(a, torch.dtype):
            dtype = a
        elif isinstance(a, (str, torch.device)):
            device = a
        elif isinstance(a, torch.Tensor):
            dtype, device = a.dtype, a.device
    device = torch.device(device) if device is not None else self.device
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", 0)
    dtype = dtype if dtype is not None else self.dtype
    if (dtype, device) == (self.dtype, self.device) and not kwargs.get(
            "copy", False):
        return self
    return torch.ops.aten._to_copy.default(self, dtype=dtype, device=device)


def _getitem(self, index):
    out, adv = _index_parts(self, index)
    return out if adv is None else torch.ops.aten.index.Tensor(out, adv)


def _setitem(self, index, value):
    out, adv = _index_parts(self, index)
    value = _to(torch.as_tensor(value, device=self.device), self.dtype)
    if adv is None:
        torch.ops.aten.copy_.default(out, value)
    else:
        torch.ops.aten.index_put_.default(out, adv, value)


#: the Tensor methods whose Python bindings take a CUDA device guard
#: (which the CPU-only build cannot), as aten ops
_CARD_METHODS = {
    "__getitem__": _getitem,
    "__setitem__": _setitem,
    "to": _to,
    "contiguous": lambda self, memory_format=torch.contiguous_format:
        torch.ops.aten.contiguous.default(self,
                                          memory_format=memory_format),
    "copy_": lambda self, src, non_blocking=False:
        torch.ops.aten.copy_.default(self, src, non_blocking),
    **{name: (lambda dtype: lambda self: _to(self, dtype))(dtype)
       for name, dtype in (("float", torch.float32), ("double", torch.float64),
                           ("half", torch.float16),
                           ("bfloat16", torch.bfloat16), ("long", torch.int64),
                           ("int", torch.int32), ("short", torch.int16),
                           ("char", torch.int8), ("byte", torch.uint8),
                           ("bool", torch.bool))},
}


@contextlib.contextmanager
def _card_methods():
    """Inside: the methods of :data:`_CARD_METHODS` run through aten ops
    on a CUDA tensor (a fake one: this is used where there is no card);
    on any other tensor they are the usual methods."""
    saved = {name: getattr(torch.Tensor, name) for name in _CARD_METHODS}

    def wrap(name, alt):
        orig = saved[name]

        def method(self, *args, **kwargs):
            if self.device.type == "cuda":
                return alt(self, *args, **kwargs)
            return orig(self, *args, **kwargs)
        return method

    for name, alt in _CARD_METHODS.items():
        setattr(torch.Tensor, name, wrap(name, alt))
    try:
        yield
    finally:
        for name, orig in saved.items():
            setattr(torch.Tensor, name, orig)


def trace_leaves(leaves, device):
    """``leaves`` as the tensors a program for ``device`` is traced on:
    CPU copies for ``"cpu"``; for ``"cuda"``, copies on the card, or fake
    CUDA tensors where there is no card. Returns ``(tensors, fake)``."""
    leaves = [as_tensor(t) for t in leaves]
    if torch.device(device).type == "cpu":
        return [t.cpu() for t in leaves], False
    if torch.cuda.is_available():
        return [t.to("cuda") for t in leaves], False
    return _fake_cuda(leaves), True


def export_flat(fn, leaves, fake=False):
    """``fn(*leaves)`` traced with ``make_fx`` on fake copies of
    ``leaves`` (nothing runs, so no argument is written) and exported
    with ``torch.export``. ``fake``: the leaves are fake CUDA tensors (no
    card here). Returns ``(ExportedProgram, inplace)``, ``inplace`` the
    positions of the arguments the program writes in place."""
    ctx = _card_methods() if fake else contextlib.nullcontext()
    with ctx:
        gm = make_fx(fn, tracing_mode="fake")(*leaves)
        ep = torch.export.export(gm, tuple(leaves), strict=False)
    return ep, _written_inputs(gm)


def _written_inputs(gm):
    """Positions of ``gm``'s placeholders that an op of its graph writes
    (an argument whose schema marks it written)."""
    holders = [n for n in gm.graph.nodes if n.op == "placeholder"]
    written = set()
    for node in gm.graph.nodes:
        schema = getattr(node.target, "_schema", None)
        if node.op != "call_function" or schema is None:
            continue
        for arg, value in zip(schema.arguments, node.args):
            if arg.alias_info is not None and arg.alias_info.is_write \
                    and value in holders:
                written.add(holders.index(value))
    return sorted(written)


def _save_program(ep, path):
    """``torch.export.save`` without the example inputs (a fake trace's
    would not load back as tensors)."""
    ep.example_inputs = None
    torch.export.save(ep, path)


def call_with_params(model, params, fn, *args):
    """``fn(model, *args)`` with ``model``'s parameters taken from
    ``params`` (a tree in the JAX layout, keys joined with dots into the
    model's parameter names) for the call, through
    ``torch.func.functional_call``: so a traced program takes the
    parameters as inputs."""
    flat = {f"model.{k}": v for k, v in bridge.flatten(params).items()}
    return torch.func.functional_call(_Bound(model, fn), flat, args)


class _Bound(torch.nn.Module):
    """``fn(model, *args)`` as a module whose only child is ``model``."""

    def __init__(self, model, fn):
        super().__init__()
        self.model = model
        self.__dict__["fn"] = fn

    def forward(self, *args):
        return self.fn(self.model, *args)


def export_program(fn, args, device="cuda"):
    """``fn(*args)`` (``args`` any trees of tensors or arrays) exported
    for ``device`` over the flat leaves of ``args``: on the card, on
    fake CUDA tensors where there is no card, or on the CPU. Returns the
    ``ExportedProgram``."""
    leaves, _ = tree_flatten(tuple(args))
    tensors, fake = trace_leaves(leaves, device)

    def flat_fn(*flat):
        return _out_leaves(fn(*tree_unflatten(tuple(args), flat)))

    return export_flat(flat_fn, tensors, fake)[0]


# --------------------------------------------------- inference export

def save_inference_model(path, fn, example_args, params):
    """Export ``fn(params, *inputs)`` with the inputs fixed to the
    example shapes (ref ``io.py:997 save_inference_model``). Writes
    ``model.cpu.pt2``, ``model.cuda.pt2``, ``params.npz``,
    ``params.bin``, ``inputs.bin`` and ``signature.json`` (see the module
    docstring). Returns ``path``."""
    os.makedirs(path, exist_ok=True)
    flat, paths = tree_flatten(params)
    flat = [as_tensor(t) for t in flat]
    inputs = [as_tensor(a) for a in example_args]
    n = len(flat)

    def flat_fn(*args):
        return _out_leaves(fn(tree_unflatten(params, args[:n]), *args[n:]))

    for device in ("cpu", "cuda"):
        tensors, fake = trace_leaves(flat + inputs, device)
        ep, _ = export_flat(flat_fn, tensors, fake)
        _save_program(ep, os.path.join(path, f"model.{device}.pt2"))
    _write_leaves(path, flat, inputs)
    sig = {
        "mode": "infer",
        "inputs": [_spec(a) for a in inputs],
        "num_params": n,
        "treedef": treedef_str(params),
        "params": [_spec(t) for t in flat],
        "paths": paths,
    }
    with open(os.path.join(path, "signature.json"), "w") as f:
        json.dump(sig, f, indent=2)
    return path


def _write_leaves(path, flat, inputs):
    np.savez(os.path.join(path, "params.npz"),
             **{f"p{i}": _to_numpy(x) for i, x in enumerate(flat)})
    _write_params_bin(os.path.join(path, "params.bin"), flat)
    _write_params_bin(os.path.join(path, "inputs.bin"), inputs)


def save_train_program(path, train_step, state, example_batch):
    """Export ONE optimizer step for a loop that feeds each iteration's
    state outputs back in (ref ``paddle/fluid/train``).
    ``train_step(state, *batch) -> (loss, new_state)``; ``state`` is any
    tree of tensors (params and optimizer slots), all on one device, for
    which the program is exported (``model.cpu.pt2`` or
    ``model.cuda.pt2``). The program's signature is the JAX package's:

    * inputs ``[*flat(state), *batch]`` (``flat(state)`` is
      ``params.bin``);
    * outputs ``[loss, *flat(new_state)]``: output ``1 + j`` feeds input
      ``j`` (``feedback``);
    * ``inplace``: the state inputs the program writes in place (and
      returns as those same tensors), such as a serving step's page
      pools.

    The step is traced with ``make_fx`` (no step runs: the trace is on
    fake copies) and then exported."""
    os.makedirs(path, exist_ok=True)
    flat, paths = tree_flatten(state)
    flat = [as_tensor(t) for t in flat]
    batch = [as_tensor(a) for a in example_batch]
    n = len(flat)
    devices = {t.device.type for t in flat + batch}
    enforce(len(devices) == 1, f"save_train_program: state and batch lie "
            f"on {sorted(devices)}; one device expected")
    device = devices.pop()

    def step_flat(*args):
        loss, new_state = train_step(tree_unflatten(state, args[:n]),
                                     *args[n:])
        new_flat, _ = tree_flatten(new_state)
        enforce(len(new_flat) == n, f"train_step returned {len(new_flat)} "
                f"state leaves, {n} expected")
        return (loss, *new_flat)

    ep, inplace = export_flat(step_flat, flat + batch)
    _save_program(ep, os.path.join(path, f"model.{device}.pt2"))
    _write_leaves(path, flat, batch)
    sig = {
        "mode": "train",
        "inputs": [_spec(a) for a in batch],
        "num_params": n,
        "feedback": [[1 + j, j] for j in range(n)],
        "treedef": treedef_str(state),
        "params": [_spec(t) for t in flat],
        "paths": paths,
        "inplace": inplace,
        "device": device,
    }
    with open(os.path.join(path, "signature.json"), "w") as f:
        json.dump(sig, f, indent=2)
    return path


# -------------------------------------------------------------- load

def _program_file(path, device):
    if path.endswith(".pt2"):
        return path
    return os.path.join(path, f"model.{torch.device(device).type}.pt2")


def load_exported(path, device="cuda"):
    """The ``ExportedProgram`` of ``device`` (``model.<device>.pt2``) in
    the export directory ``path`` (or the ``.pt2`` file ``path``). The
    kernels' ops are registered on import of this module, so a process
    with no model code loads a program of the card path."""
    fp = _program_file(path, device)
    enforce(os.path.exists(fp), f"{fp} does not exist: export for "
            f"{torch.device(device).type} with save_inference_model or "
            "save_train_program")
    return torch.export.load(fp)


def load_program(path, device="cuda"):
    """Load a program back into a runnable callable of its flat inputs,
    with no access to the original model code (ref ``framework.py:3459
    parse_from_string``): the program of ``device`` (the card by
    default; raises without one unless ``device="cpu"``). The callable
    returns the program's outputs as a tuple and keeps the
    ``ExportedProgram`` as ``.program``."""
    resolve_device(device)
    ep = load_exported(path, device)
    module = ep.module()

    def run(*args):
        with torch.no_grad():
            return tuple(module(*args))

    run.program = ep
    return run


def load_inference_model(path, raw=False, device="cuda"):
    """Load an exported model (ref ``io.py:1201``). Default: a runnable
    predictor over the program of ``device``, with the parameters of
    ``params.npz`` on that device, ``.signature`` and ``.params``. With
    ``raw=True``: ``(ExportedProgram, params, signature)``, the port's
    twin of the JAX package's (StableHLO, params, signature) triple."""
    dev = resolve_device(device)
    with open(os.path.join(path, "signature.json")) as f:
        sig = json.load(f)
    data = np.load(os.path.join(path, "params.npz"))
    flat = [_from_spec(data[f"p{i}"], spec, dev)
            for i, spec in enumerate(sig["params"])]
    if raw:
        return load_exported(path, dev), flat, sig
    if not os.path.exists(_program_file(path, dev)):
        raise EnforceError(
            f"{path} has no model.{dev.type}.pt2: re-export with "
            "save_inference_model, or pass raw=True")
    prog = load_program(path, dev)

    def predictor(*inputs):
        with torch.inference_mode():
            out = prog(*flat, *inputs)
        return out[0] if len(out) == 1 else out

    predictor.signature = sig
    predictor.params = flat
    return predictor


class Predictor:
    """In-process predictor (ref ``analysis_predictor.h:47``): runs
    ``fn(params, *inputs)`` under ``torch.inference_mode()``."""

    def __init__(self, fn, params):
        self.fn = fn
        self.params = params

    def run(self, *inputs):
        with torch.inference_mode():
            return self.fn(self.params, *inputs)

    __call__ = run


# ---------------------------------------------------- the PTPB archive

#: PJRT_Buffer_Type codes (xla/pjrt/c/pjrt_c_api.h) for the C++ predictor
_PJRT_DTYPE = {
    np.dtype(np.bool_): 1, np.dtype(np.int8): 2, np.dtype(np.int16): 3,
    np.dtype(np.int32): 4, np.dtype(np.int64): 5, np.dtype(np.uint8): 6,
    np.dtype(np.uint16): 7, np.dtype(np.uint32): 8, np.dtype(np.uint64): 9,
    np.dtype(np.float16): 10, np.dtype(np.float32): 11,
    np.dtype(np.float64): 12,
}


def _leaf_bytes(x):
    """``(code, shape, raw bytes)`` of one leaf: a tensor or a numpy
    array (the JAX package's bf16 arrays included); bf16 is code 13, a
    type without a code is stored as f32."""
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return 13, tuple(t.shape), t.view(torch.int16).numpy().tobytes()
        x = t.numpy()
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        return 13, a.shape, a.tobytes()
    code = _PJRT_DTYPE.get(a.dtype)
    if code is None:
        a = a.astype(np.float32)
        code = 11
    return code, a.shape, a.tobytes()


def _write_params_bin(path, flat):
    """Framework binary params for the C++ predictor (``csrc/predictor``):
    magic PTPB | u32 version | u32 n | per tensor u32 dtype, u32 ndim,
    i64 dims[], u64 nbytes, raw bytes. bfloat16 is stored as code 13."""
    with open(path, "wb") as f:
        f.write(b"PTPB")
        f.write(struct.pack("<II", 1, len(flat)))
        for x in flat:
            code, shape, raw = _leaf_bytes(x)
            f.write(struct.pack("<II", code, len(shape)))
            f.write(struct.pack(f"<{len(shape)}q", *shape))
            f.write(struct.pack("<Q", len(raw)))
            f.write(raw)


_PJRT_DTYPE_INV = {v: k for k, v in _PJRT_DTYPE.items()}


def read_params_bin(path):
    """Parse a PTPB tensor archive (``params.bin``, ``inputs.bin``) back
    into numpy arrays (bf16 widened to f32)."""
    out = []
    with open(path, "rb") as f:
        blob = f.read()
    if blob[:4] != b"PTPB":
        raise ValueError(f"{path}: bad magic")
    version, n = struct.unpack_from("<II", blob, 4)
    if version != 1:
        raise ValueError(f"{path}: unsupported version {version}")
    off = 12
    for _ in range(n):
        code, ndim = struct.unpack_from("<II", blob, off)
        off += 8
        dims = struct.unpack_from(f"<{ndim}q", blob, off)
        off += 8 * ndim
        (nbytes,) = struct.unpack_from("<Q", blob, off)
        off += 8
        raw = blob[off:off + nbytes]
        off += nbytes
        if code == 13:  # bf16: widen via uint16 -> float32
            u = np.frombuffer(raw, np.uint16).astype(np.uint32) << 16
            arr = u.view(np.float32).reshape(dims)
        else:
            dt = _PJRT_DTYPE_INV.get(code)
            if dt is None:
                raise ValueError(f"{path}: unknown dtype code {code}")
            arr = np.frombuffer(raw, dt).reshape(dims)
        out.append(arr)
    return out
