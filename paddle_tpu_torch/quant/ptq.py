"""Post-training quantization, freeze and int8 export — the port of
``paddle_tpu/quant/ptq.py``.

The pipeline, on the port's stateful modules (each step works on the
model in place and returns it, where the reference returns new variable
trees)::

    qmodel = qat.quantize_model(model, cfg)      # swap layers
    ptq.calibrate(qmodel, batches)               # activation scales
    ptq.freeze(qmodel)                           # bake weight quant
    payload = ptq.export_int8(qmodel)            # int8 weights + scales
    ptq.save_int8_inference_model(path, qmodel, example_args,
                                  float_model=model)

:func:`int8_linear` is the reference's plain dequantize-then-matmul (the
JAX package has no Pallas kernel there, so the port has none either).
"""

import torch

from paddle_tpu_torch import bridge
from paddle_tpu_torch.io.inference import (call_with_params, as_tensor,
                                           save_inference_model)
from paddle_tpu_torch.quant import ops as Q
from paddle_tpu_torch.quant.qat import (QuantizedConv2D, QuantizedLinear,
                                        _ActQuant)

_QUANTIZED = (QuantizedLinear, QuantizedConv2D)


def _quantized_leaves(model):
    """``(path, module)`` of every quantized layer, the root included,
    ``path`` a tuple of child names (ref: ``ptq.py:27``)."""
    for name, mod in model.named_modules():
        if isinstance(mod, _QUANTIZED):
            yield (tuple(name.split(".")) if name else ()), mod


def _weight_name(path):
    """The parameter name of the weight of the layer at ``path`` (the
    payload's ``/``-joined key)."""
    return f"{path.replace('/', '.')}.weight" if path else "weight"


def _weight_axis(mod):
    cfg = mod.quant_cfg
    return (mod.CHANNEL_AXIS
            if cfg.weight_quantize_type == "channel_wise_abs_max" else None)


def calibrate(qmodel, batches, **kwargs):
    """Run calibration forwards so the activation scales settle (ref:
    ``ptq.py:39``): eval behaviour (dropout off, batch norm on its running
    statistics) while every quantizer's scale updates. ``batches`` are
    tensors or tuples of forward arguments. Returns ``qmodel``."""
    quantizers = [m for m in qmodel.modules() if isinstance(m, _ActQuant)]
    was_training = qmodel.training
    qmodel.eval()
    for m in quantizers:
        m.calibrating = True
    try:
        with torch.no_grad():
            for batch in batches:
                args = batch if isinstance(batch, (list, tuple)) else (batch,)
                qmodel(*args, **kwargs)
    finally:
        for m in quantizers:
            m.calibrating = False
        qmodel.train(was_training)
    return qmodel


def freeze(qmodel):
    """Bake each quantized layer's weight quantization into its stored
    float weight, in place (ref: ``ptq.py:58``): ``dequantize(quantize(
    w))`` in the weight's dtype. Returns ``qmodel``."""
    with torch.no_grad():
        for _, mod in _quantized_leaves(qmodel):
            axis, bits = _weight_axis(mod), mod.quant_cfg.weight_bits
            w = mod.weight
            scale = Q.abs_max_scale(w, axis)
            w.copy_(Q.dequantize_from_int(
                Q.quantize_to_int(w, scale, bits, axis), scale, bits,
                axis).to(w.dtype))
    return qmodel


def export_int8(qmodel):
    """The serving payload (ref: ``ptq.py:97``): per quantized layer,
    keyed by its path joined with ``/``, the int8 weight and its scale,
    the bits and the channel axis, the bias, and the activation scale
    and bits where the layer keeps one."""
    out = {}
    with torch.no_grad():
        for path, mod in _quantized_leaves(qmodel):
            cfg = mod.quant_cfg
            axis = _weight_axis(mod)
            w = mod.weight.detach()
            scale = Q.abs_max_scale(w, axis)
            entry = {
                "weight_int8": Q.quantize_to_int(w, scale, cfg.weight_bits,
                                                 axis),
                "weight_scale": scale,
                "weight_bits": cfg.weight_bits,
                "channel_axis": axis,
            }
            if mod.bias is not None:
                entry["bias"] = mod.bias.detach()
            if "scale" in mod.input_quant._buffers:
                entry["act_scale"] = mod.input_quant.scale.detach()
                entry["act_bits"] = cfg.activation_bits
            out["/".join(path)] = entry
    return out


def int8_linear(x, entry):
    """The reference's int8 serving matmul (ref: ``ptq.py:131``): the
    dequantized weight, then ``x @ w`` and the bias."""
    w = Q.dequantize_from_int(entry["weight_int8"], entry["weight_scale"],
                              entry["weight_bits"], entry["channel_axis"])
    y = torch.as_tensor(x) @ w
    if "bias" in entry:
        y = y + entry["bias"]
    return y


def save_int8_inference_model(path, qmodel, example_args, float_model=None,
                              **kwargs):
    """Export an int8 serving artifact through
    ``io.inference.save_inference_model`` (ref: ``ptq.py:146``). Its
    params are ``{"float": the remaining float parameters, "int8": {layer
    path: {"w": int8 weight, "s": scale}}}``, so ``params.bin`` holds the
    quantized weights as int8; the program dequantizes them inline and
    runs ``float_model`` (the unquantized twin of ``qmodel``, which
    matches :func:`freeze`'s numerics exactly) over them, or ``qmodel``
    itself without one (re-quantizing the dequantized weights, a second
    rounding). ``kwargs`` go to the forward. Returns ``path``."""
    serve_model = float_model if float_model is not None else qmodel
    entries = export_int8(qmodel)
    meta = {name: (e["weight_bits"], e["channel_axis"])
            for name, e in entries.items()}
    weights = {_weight_name(name) for name in entries}
    params = bridge._nest((name, p.detach())
                          for name, p in serve_model.named_parameters()
                          if name not in weights)
    mixed = {"float": params,
             "int8": {name: {"w": e["weight_int8"], "s": e["weight_scale"]}
                      for name, e in entries.items()}}
    buffers = {name: b.detach() for name, b in serve_model.named_buffers()}

    def fwd(mixed_params, *inputs):
        flat = bridge.flatten(mixed_params["float"])
        device = next(iter(flat.values())).device if flat else None
        for name, payload in mixed_params["int8"].items():
            bits, axis = meta[name]
            w = Q.dequantize_from_int(payload["w"], payload["s"], bits, axis)
            flat[_weight_name(name)] = w
            device = w.device
        # the model's buffers (batch norm's statistics) ride along as
        # constants of the program, on the params' device
        flat.update({k: as_tensor(b).to(device) for k, b in buffers.items()})
        return call_with_params(serve_model, flat,
                                lambda m, *a: m(*a, **kwargs), *inputs)

    return save_inference_model(path, fwd, example_args, mixed)
