"""The one weight bridge between the JAX package's params and the port.

The JAX package's params are a nested dict (lists for repeated blocks)
whose leaves the caller has turned into **numpy** arrays, with paths such
as ``blocks/<i>/attn/wq``, ``blocks/<i>/fc1/weight``,
``blocks/<i>/ln1/scale``, ``tok_emb/weight`` and ``ln_f/bias``. The port
names its parameters the same way, joined with dots, and keeps the same
``[in, out]`` layout for every projection (``x @ W``), so the bridge
copies arrays without transposing any. The bridge imports neither jax
nor ``paddle_tpu``.
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


def load_params(model, params):
    """Copy a JAX param tree (numpy leaves) into ``model``'s parameters,
    on the model's device and in its dtype. Every parameter must be
    present and no extra leaf may be left over. Weight-only int8 trees
    (``weight_q`` / ``w*_q`` leaves) raise ``NotImplementedError``."""
    flat = flatten(params)
    quant = [k for k in flat if k.endswith(("_q", "_scale"))]
    if quant:
        raise NotImplementedError(
            f"weight-only int8 params are not ported: {quant[:3]}")
    own = dict(model.named_parameters())
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


def export_params(model):
    """The port's parameters as the JAX package's nested param tree of
    numpy arrays (lists become dicts keyed by the block index, as the JAX
    package's own tree holds them)."""
    tree = {}
    for name, p in model.named_parameters():
        node = tree
        parts = name.split(".")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = p.detach().cpu().numpy()
    return tree
