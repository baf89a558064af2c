"""The one weight bridge between the JAX package's params and the port:
parameters, and the optimizer's state beside them.

The JAX package's params are a nested dict (lists for repeated blocks)
whose leaves the caller has turned into **numpy** arrays, with paths such
as ``blocks/<i>/attn/wq``, ``blocks/<i>/fc1/weight``,
``blocks/<i>/ln1/scale``, ``tok_emb/weight`` and ``ln_f/bias``. The port
names its parameters the same way, joined with dots, and keeps the same
``[in, out]`` layout for every projection (``x @ W``), so the bridge
copies arrays without transposing any. A scan-stacked subtree (the JAX
package's ``ScanLayers``, ``scan_layers=True``: ``encoder/layers/layer/
<leaf>`` with a leading layer axis) loads into the port's unrolled
layers ``encoder.layers.<i>.<leaf>``; :func:`export_params` writes the
unrolled tree. The bridge imports neither jax nor ``paddle_tpu``.

Optimizer state has the JAX package's shape ``{"step": int, "slots":
<param tree of {"moment1", "moment2"}>}`` (under ``amp.decorate``,
``{"inner": ...}`` around it); :func:`load_opt_state` and
:func:`export_opt_state` carry it to and from the port's optimizer, so
both sides can continue from the same state.
"""

import numpy as np
import torch


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


def load_params(model, params):
    """Copy a JAX param tree (numpy leaves) into ``model``'s parameters,
    on the model's device and in its dtype; a scan-stacked subtree loads
    into the unrolled layers. Every parameter must be present and no
    extra leaf may be left over. Weight-only int8 trees (``weight_q`` /
    ``w*_q`` leaves) raise ``NotImplementedError``."""
    flat = flatten(params)
    quant = [k for k in flat if k.endswith(("_q", "_scale"))]
    if quant:
        raise NotImplementedError(
            f"weight-only int8 params are not ported: {quant[:3]}")
    own = dict(model.named_parameters())
    flat = _unstack(flat, own)
    missing = sorted(set(own) - set(flat))
    extra = sorted(set(flat) - set(own))
    if missing or extra:
        raise KeyError(f"param trees differ: missing {missing[:5]}, "
                       f"extra {extra[:5]}")
    with torch.no_grad():
        for name, p in own.items():
            arr = np.asarray(flat[name])
            if tuple(arr.shape) != tuple(p.shape):
                raise ValueError(f"{name}: shape {arr.shape} vs "
                                 f"{tuple(p.shape)}")
            p.copy_(torch.from_numpy(np.array(arr)))
    return model


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
    package's own tree holds them)."""
    return _nest((name, p.detach().cpu().numpy())
                 for name, p in model.named_parameters())


def _unwrap(opt, state=None):
    """The optimizer that holds the slots, and the state for it: an amp
    wrapper's ``inner`` takes the ``{"inner": ...}`` level."""
    inner = getattr(opt, "inner", None)
    if inner is None:
        return opt, state
    if state is not None:
        if "inner" not in state:
            raise KeyError("an amp optimizer takes {'inner': state}")
        state = state["inner"]
    return inner, state


def load_opt_state(opt, model, state):
    """Set ``opt``'s step count and per-parameter slots from a JAX
    optimizer state (numpy or array leaves), on each parameter's device,
    in the dtypes the optimizer's own slots take (its ``state_dtype``
    rule). Every parameter of ``model`` must have its slots in the
    state."""
    inner, state = _unwrap(opt, state)
    flat = flatten(state["slots"])
    own = dict(model.named_parameters())
    slot_names = {}
    for key in flat:
        name, _, slot = key.rpartition(".")
        slot_names.setdefault(name, []).append(slot)
    missing = sorted(set(own) - set(slot_names))
    extra = sorted(set(slot_names) - set(own))
    if missing or extra:
        raise KeyError(f"slot trees differ: missing {missing[:5]}, extra "
                       f"{extra[:5]}")
    for name, p in own.items():
        template = inner.slots(p)
        if sorted(template) != sorted(slot_names[name]):
            raise KeyError(f"{name}: slots {sorted(slot_names[name])}, the "
                           f"optimizer keeps {sorted(template)}")
        st = inner.state[p]
        st.clear()
        for slot, like in template.items():
            arr = np.asarray(flat[f"{name}.{slot}"])
            if tuple(arr.shape) != tuple(p.shape):
                raise ValueError(f"{name}.{slot}: shape {arr.shape} vs "
                                 f"{tuple(p.shape)}")
            st[slot] = _to_torch(arr).to(p.device, like.dtype)
    inner.step_count = int(np.asarray(state["step"]))
    return opt


def _to_torch(arr):
    """A numpy array as a torch tensor; bf16 (numpy's ml_dtypes type)
    goes through f32, exactly."""
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(arr))


def export_opt_state(opt, model):
    """The port optimizer's state as the JAX package's tree (numpy
    leaves; bf16 slots as f32). A parameter that has not been stepped yet
    exports the zero slots the optimizer would start it with."""
    inner, _ = _unwrap(opt)

    def slots(p):
        st = inner.state.get(p) or inner.slots(p)
        return {k: v.detach().float().cpu().numpy() if v.dtype ==
                torch.bfloat16 else v.detach().cpu().numpy()
                for k, v in st.items()}

    state = {"step": np.int32(inner.step_count),
             "slots": _nest((name, slots(p))
                            for name, p in model.named_parameters())}
    return {"inner": state} if inner is not opt else state
