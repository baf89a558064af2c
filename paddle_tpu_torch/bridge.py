"""The one weight bridge between the JAX package's params and the port:
parameters, the model's state (batch norm's running statistics, the
port's buffers), and the optimizer's state beside them.

The JAX package's params are a nested dict (lists for repeated blocks)
whose leaves the caller has turned into **numpy** arrays, with paths such
as ``blocks/<i>/attn/wq``, ``blocks/<i>/fc1/weight``,
``blocks/<i>/ln1/scale``, ``tok_emb/weight`` and ``ln_f/bias``. The port
names its parameters the same way, joined with dots, and keeps the same
``[in, out]`` layout for every projection (``x @ W``), so the bridge
copies arrays without transposing any. A leaf a module declares on
itself sits at its module's level under its own name (``SkipGramNCE``'s
``nce_weight`` and ``nce_bias``; ``SpectralNorm``'s ``u`` and ``v`` in
the state), and the port's attribute of that name takes it. A
scan-stacked subtree (the JAX package's ``ScanLayers``,
``scan_layers=True``: ``encoder/layers/layer/<leaf>`` with a leading
layer axis) loads into the port's unrolled
layers ``encoder.layers.<i>.<leaf>``, and as it is into a scan model
(``scan_layers=True``, whose parameters are that tree's);
:func:`export_params` writes the model's own layout. A weight-only int8
tree (``fc1.weight_q`` / ``fc1.weight_scale``, ``attn.wq_q`` ...) loads
into a float model, whose layers it makes int8, and exports back as it
came. The bridge imports neither jax nor ``paddle_tpu``.

Optimizer state has the JAX package's shape: ``{"step": int, "slots":
<param tree of slot dicts>}`` for an optimizer, ``{"inner": ...}``
around it under ``amp.decorate``, ``{"inner", "slow", "step"}`` for
``Lookahead``, ``{"shadow", "step"}`` and the window sums for the
averages. The port's objects hold the same trees keyed by parameter name
(``state_tree(named)``); :func:`load_opt_state` and
:func:`export_opt_state` convert between the two, so both sides can
continue from the same state.

A ``SparseTable``'s state (``parallel/sparse.py``) crosses the same way:
``{"table": [V, D], "step": int, "slots": {name: [V, ...]}}`` on both
sides (:func:`load_table_state`, :func:`export_table_state`).
"""

import numpy as np
import torch

from paddle_tpu_torch.core.device import resolve_device


def flatten(params, prefix=""):
    """Nested dict/list of arrays -> ``{"a.b.0.c": array}``."""
    out = {}
    items = (params.items() if isinstance(params, dict)
             else enumerate(params))
    for key, val in items:
        name = f"{prefix}{key}"
        if isinstance(val, (dict, list, tuple)):
            out.update(flatten(val, name + "."))
        else:
            out[name] = val
    return out


#: the child name under which ScanLayers stacks its layers
SCAN_CHILD = "layer"


def _unstack(flat, own):
    """Split each scan-stacked leaf ``<prefix>.layer.<rest>`` whose
    unrolled form ``<prefix>.0.<rest>`` is a parameter of the model into
    ``<prefix>.<i>.<rest>``, one per entry of its leading axis."""
    out = {}
    for name, arr in flat.items():
        prefix, sep, rest = name.partition(f".{SCAN_CHILD}.")
        if sep and name not in own and f"{prefix}.0.{rest}" in own:
            arr = np.asarray(arr)
            for i in range(arr.shape[0]):
                out[f"{prefix}.{i}.{rest}"] = arr[i]
        else:
            out[name] = arr
    return out


#: the weights weight-only int8 quantization replaces by ``<name>_q`` and
#: ``<name>_scale`` (``paddle_tpu/quant/weight_only.py:90``): a Linear's or
#: Embedding's ``weight`` and attention's ``w{q,k,v,o}``
_INT8_WEIGHTS = ("weight", "wq", "wk", "wv", "wo")


def _take_int8_layout(model, flat):
    """Give each layer whose tree leaves are a weight-only int8 pair
    (``<path>.weight_q`` and ``<path>.weight_scale``) that layout in
    ``model`` (:func:`quant.weight_only.set_int8`), so that the pair loads
    into it; a layer already int8 is left as it is."""
    from paddle_tpu_torch.quant.weight_only import set_int8
    for name in flat:
        path, _, leaf = name.rpartition(".")
        base = leaf[:-2] if leaf.endswith("_q") else None
        if base not in _INT8_WEIGHTS:
            continue
        scale = f"{path}.{base}_scale" if path else f"{base}_scale"
        if scale not in flat:
            raise KeyError(f"{name}: an int8 weight without its scale "
                           f"{scale}")
        module = model.get_submodule(path)
        w = module._parameters.get(base)
        if w is None:
            continue
        q, s = _to_torch(flat[name]), _to_torch(flat[scale])
        if tuple(q.shape) != tuple(w.shape) or q.dtype != torch.int8:
            raise ValueError(f"{name}: {q.dtype} {tuple(q.shape)}, the "
                             f"weight is {tuple(w.shape)}")
        set_int8(module, base, q.to(w.device),
                 s.to(w.device, w.dtype).clone())


def load_params(model, params):
    """Copy a JAX param tree (numpy leaves) into ``model``'s parameters,
    on the model's device and in its dtype. A scan-stacked subtree loads
    as it is into a scan model's stacked layers, or into an unrolled
    model's layers one by one. A weight-only int8 pair (the JAX package's
    ``quantize_weights_int8`` tree: ``weight_q`` / ``weight_scale``,
    ``wq_q`` / ``wq_scale`` ...) turns its layer int8 and loads into it.
    Every parameter must be present and no extra leaf may be left
    over."""
    flat = flatten(params)
    _take_int8_layout(model, flat)
    own = dict(model.named_parameters())
    _copy_into(own, _unstack(flat, own), "param")
    return model


def _copy_into(own, flat, what):
    """Copy each ``flat`` array into the tensor of ``own`` of its name (in
    that tensor's dtype, on its device); the names must be the same sets
    and each shape the tensor's."""
    missing = sorted(set(own) - set(flat))
    extra = sorted(set(flat) - set(own))
    if missing or extra:
        raise KeyError(f"{what} trees differ: missing {missing[:5]}, "
                       f"extra {extra[:5]}")
    with torch.no_grad():
        for name, t in own.items():
            src = _to_torch(flat[name])
            if tuple(src.shape) != tuple(t.shape):
                raise ValueError(f"{name}: shape {tuple(src.shape)} vs "
                                 f"{tuple(t.shape)}")
            t.copy_(src)


def _nest(flat_items):
    """``[("a.b.c", value)]`` -> nested dicts (list indices become string
    keys, as :func:`export_params` writes them)."""
    tree = {}
    for name, val in flat_items:
        node = tree
        parts = name.split(".")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = val
    return tree


def export_params(model):
    """The port's parameters as the JAX package's nested param tree of
    numpy arrays (lists become dicts keyed by the block index, as the JAX
    package's own tree holds them; a scan model's stacked layers stay
    stacked under ``layer``; a weight-only int8 pair exports as the pair,
    int8 and its scale)."""
    return _nest((name, p.detach().cpu().numpy())
                 for name, p in model.named_parameters())


def param_tree(model):
    """The model's parameters themselves (tensors, not copies) as the JAX
    package's nested param tree, laid out as :func:`export_params` lays
    it out: the tree ``io.save_inference_model`` flattens in the JAX
    package's order."""
    return _nest(model.named_parameters())


def load_state(model, state):
    """Copy the JAX package's ``"state"`` collection (``variables["state"]``:
    batch norm's ``mean`` and ``variance``, numpy leaves) into ``model``'s
    buffers of the same names, as :func:`load_params` copies the params:
    in the buffers' dtype and on their device, no transposes. Every buffer
    must be present and no extra leaf may be left over."""
    _copy_into(dict(model.named_buffers()), flatten(state), "state")
    return model


def export_state(model):
    """The port's buffers as the JAX package's nested ``"state"`` tree of
    numpy arrays."""
    return _nest((name, b.detach().cpu().numpy())
                 for name, b in model.named_buffers())


def _to_torch(arr):
    """A numpy array as a torch tensor; bf16 (numpy's ml_dtypes type)
    goes through f32, exactly."""
    if isinstance(arr, torch.Tensor):
        return arr
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(arr))


def _to_numpy(t):
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()


def _named_level(node, names):
    """True when ``node`` is keyed by every parameter name (a level of
    the port's state tree that the JAX package holds as a param
    tree)."""
    return isinstance(node, dict) and node and set(node) == names


def _from_jax(template, tree, names):
    """The JAX state ``tree`` in the form of the port's ``template``:
    param-tree levels become dicts keyed by parameter name."""
    if _named_level(template, names):
        flat = flatten(tree)
        out, used = {}, set()
        for name, like in template.items():
            if isinstance(like, dict):
                keys = {slot: f"{name}.{slot}" for slot in like}
                out[name] = {slot: flat[k] for slot, k in keys.items()
                             if k in flat}
                used.update(k for k in keys.values() if k in flat)
            elif name in flat:
                out[name] = flat[name]
                used.add(name)
        if used != set(flat):
            raise KeyError(f"state leaves the optimizer does not keep: "
                           f"{sorted(set(flat) - used)[:5]}")
        missing = sorted(n for n, like in template.items()
                         if n not in out or (isinstance(like, dict)
                                             and sorted(out[n]) != sorted(
                                                 like)))
        if missing:
            raise KeyError(f"state lacks the slots of {missing[:5]}")
        return {k: _from_jax(template[k], v, names) for k, v in out.items()}
    if isinstance(template, dict):
        if not isinstance(tree, dict) or sorted(tree) != sorted(template):
            got = sorted(tree) if isinstance(tree, dict) else type(tree)
            raise KeyError(f"state keys {got}, the optimizer keeps "
                           f"{sorted(template)}")
        return {k: _from_jax(template[k], tree[k], names) for k in template}
    return _to_torch(tree)


def _to_jax(tree, names):
    """The port's state tree as the JAX package's (numpy leaves, bf16 as
    f32, param-tree levels nested by name)."""
    if _named_level(tree, names):
        return _nest((name, _to_jax(v, names)) for name, v in tree.items())
    if isinstance(tree, dict):
        return {k: _to_jax(v, names) for k, v in tree.items()}
    if tree.dim() == 0 and not tree.is_floating_point():
        return np.int32(int(tree))
    return _to_numpy(tree)


def load_opt_state(opt, model, state):
    """Set the state of ``opt`` (an optimizer, ``amp.decorate``'s wrapper,
    ``Lookahead``, ``RecomputeOptimizer``, or an average) from the JAX
    package's state for ``model`` (numpy or array leaves): the step
    counts and every per-parameter slot, on each parameter's device, in
    the dtypes the port's own state takes (its ``state_dtype`` rule).
    Every parameter of ``model`` must have its state, and no leaf may be
    left over."""
    named = dict(model.named_parameters())
    template = opt.state_tree(named)
    opt.load_state_tree(named, _from_jax(template, state, set(named)))
    return opt


def export_opt_state(opt, model):
    """``opt``'s state as the JAX package's tree (numpy leaves; bf16
    slots as f32). A parameter not stepped yet exports the zero slots the
    optimizer would start it with."""
    named = dict(model.named_parameters())
    return _to_jax(opt.state_tree(named), set(named))


def load_table_state(tbl, state, device="cuda"):
    """A JAX ``SparseTable`` state (numpy or array leaves) as the port's
    state for ``tbl`` on ``device``: the table and every slot in the
    table's dtype, the step an int32 0-d tensor. The slot names must be
    those ``tbl``'s optimizer keeps, and every shape ``[V, ...]``."""
    dev = resolve_device(device)
    want = sorted(tbl.opt.slots(torch.zeros((1, tbl.dim))))
    if sorted(state["slots"]) != want:
        raise KeyError(f"table slots {sorted(state['slots'])}, the "
                       f"optimizer keeps {want}")
    shape = (tbl.vocab_size, tbl.dim)

    def leaf(name, arr):
        t = _to_torch(arr)
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)} vs {shape}")
        return t.to(dev, tbl.dtype).clone()

    return {"table": leaf("table", state["table"]),
            "step": torch.tensor(int(np.asarray(state["step"])),
                                 dtype=torch.int32, device=dev),
            "slots": {n: leaf(n, v) for n, v in state["slots"].items()}}


def export_table_state(state):
    """The port's ``SparseTable`` state as the JAX package's (numpy
    leaves, the step an int32 scalar). The leaves are copies: a CPU
    tensor's ``.numpy()`` shares its memory, and the port's push writes
    the table in place."""
    return {"table": _to_numpy(state["table"]).copy(),
            "step": np.int32(int(state["step"])),
            "slots": {n: _to_numpy(v).copy()
                      for n, v in state["slots"].items()}}
