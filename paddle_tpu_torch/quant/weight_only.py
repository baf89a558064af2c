"""Weight-only int8 serving (ref: ``paddle_tpu/quant/weight_only.py``).

:func:`quantize_weights_int8` replaces, in place, every ``Linear`` kernel,
every ``MultiHeadAttention`` projection and (with ``include_embeddings``)
every ``Embedding`` table of a model by the reference's int8 pair:

    ``weight`` -> ``weight_q`` (int8) and ``weight_scale`` (the weight's
    dtype, one step per channel)

(``wq`` -> ``wq_q`` / ``wq_scale`` and so on for attention), so the
parameter names are the JAX tree's and ``paddle_tpu_torch/bridge.py``
carries int8 trees across both ways. The pair are frozen parameters
(``requires_grad=False``): an int8 tensor cannot take a gradient, and as
parameters they move with the model, cast under ``amp`` (the scale) and
export with :func:`bridge.export_params` like any other leaf.

Scale axes make the dequant exact on the consuming contraction, as in
the reference: per output column for ``[in, out]`` kernels (``x @ (q *
s) == (x @ q) * s``), per row for embedding tables (the lookup gathers
``q[ids] * s[ids]``; the tied head computes ``(x @ q.T) * s``). The
consuming layers are in ``nn/layers.py``.
"""

from torch import nn

from paddle_tpu_torch.nn import layers as L
from paddle_tpu_torch.quant import ops as Q

__all__ = ["quantize_weights_int8", "set_int8"]


def _q8(w, axis):
    """(int8 values, dequant step in ``w``'s dtype) of ``w`` along the
    channel ``axis`` (ref: ``weight_only.py:46``)."""
    scale = Q.abs_max_scale(w, axis)
    q = Q.quantize_to_int(w, scale, 8, axis)
    return q, (scale / Q.qrange(8)).to(w.dtype)


def set_int8(module, name, q, scale):
    """Replace ``module``'s float parameter ``name`` by the frozen pair
    ``<name>_q`` (int8) and ``<name>_scale``."""
    delattr(module, name)
    module.register_parameter(f"{name}_q",
                              nn.Parameter(q, requires_grad=False))
    module.register_parameter(f"{name}_scale",
                              nn.Parameter(scale, requires_grad=False))


def targets(module, include_embeddings=True):
    """``{param name: channel axis}`` of the weights the transform takes
    from ``module``: exact types only, since a subclass may read
    ``weight`` in a forward of its own that does not know the int8
    layout (ref: ``weight_only.py:73``)."""
    if type(module) is L.Linear:
        return {"weight": 1}                  # [in, out]: per out column
    if type(module) is L.MultiHeadAttention:
        return {f"w{n}": 1 for n in ("q", "k", "v", "o")}
    if include_embeddings and type(module) is L.Embedding:
        return {"weight": 0}                  # [vocab, dim]: per row
    return {}


def quantize_weights_int8(model, include_embeddings=True, min_size=4096):
    """Quantize ``model``'s serving weights to int8 in place and return
    it. A 2-D weight of fewer than ``min_size`` elements stays float (its
    bytes do not matter and small layers lose the most); a stacked
    (scan-over-layers) weight is 3-D and stays float, as in the
    reference. Biases, norms and everything else are untouched."""
    for module in list(model.modules()):
        for name, axis in targets(module, include_embeddings).items():
            w = module._parameters.get(name)
            if w is None or w.ndim != 2 or w.numel() < min_size:
                continue
            q, s = _q8(w.detach(), axis)
            set_int8(module, name, q, s)
    return model
