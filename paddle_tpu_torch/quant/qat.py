"""Quantization-aware training — the port of ``paddle_tpu/quant/qat.py``
(the QuantizationTransformPass successor).

:func:`quantize_model` swaps the ``Linear`` and ``Conv2D`` layers of a
model for quantized subclasses that fake-quantize their weight and their
input activation in forward (``quant/ops.py``, straight-through
gradients). The swapped layer keeps the float layer's parameters (the
same tensors) and gains ``input_quant``, an :class:`_ActQuant` whose
moving-average scale is module state: the buffers ``scale`` (f32, 1.0)
and ``step`` (int32, 0), named as the reference's state tree names them
(``<layer>/input_quant/scale``), so ``bridge.load_state`` and
``bridge.export_state`` carry them across. They update in training mode
(``model.train()``) and while calibrating (``ptq.calibrate``), on the
device, with no host read.
"""

import dataclasses

import torch
from torch import nn

from paddle_tpu_torch.core.enforce import enforce
from paddle_tpu_torch.nn import layers as L
from paddle_tpu_torch.ops import nn as F
from paddle_tpu_torch.quant import ops as Q

WEIGHT_QUANT_TYPES = ("abs_max", "channel_wise_abs_max")
ACT_QUANT_TYPES = ("abs_max", "moving_average_abs_max", "range_abs_max")


@dataclasses.dataclass
class QuantConfig:
    """ref: ``qat.py:31`` (the QuantizationTransformPass arguments)."""
    weight_bits: int = 8
    activation_bits: int = 8
    weight_quantize_type: str = "channel_wise_abs_max"
    activation_quantize_type: str = "moving_average_abs_max"
    moving_rate: float = 0.9
    window_size: int = 10000

    def __post_init__(self):
        enforce(self.weight_quantize_type in WEIGHT_QUANT_TYPES,
                "unknown weight_quantize_type %s", self.weight_quantize_type)
        enforce(self.activation_quantize_type in ACT_QUANT_TYPES,
                "unknown activation_quantize_type %s",
                self.activation_quantize_type)


class _ActQuant(nn.Module):
    """Input-activation fake quantizer with a stateful scale (ref:
    ``qat.py:52``). ``calibrating`` is set by ``ptq.calibrate``: the
    scale updates as in training while the model stays in eval mode."""

    def __init__(self, cfg: QuantConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.calibrating = False
        if cfg.activation_quantize_type != "abs_max":
            self.register_buffer("scale", torch.ones((), device=device))
            self.register_buffer("step", torch.zeros(
                (), dtype=torch.int32, device=device))

    def forward(self, x):
        cfg = self.cfg
        if cfg.activation_quantize_type == "abs_max":
            return Q.fake_quant_abs_max(x, cfg.activation_bits)
        prev = self.scale
        if self.training or self.calibrating:
            step = self.step
            xd = x.detach()
            if cfg.activation_quantize_type == "moving_average_abs_max":
                # seed from the first observed batch instead of the 1.0 init
                scale = torch.where(
                    step == 0, Q.abs_max_scale(xd),
                    Q.moving_average_scale(prev, xd, cfg.moving_rate))
            else:  # range_abs_max
                scale = Q.range_abs_max_scale(prev, xd, step,
                                              cfg.window_size)
            with torch.no_grad():
                self.scale.copy_(scale)
                self.step.add_(1)
        else:
            scale = prev
        return Q.fake_quant_dequant(x, scale.detach().to(x.dtype),
                                    cfg.activation_bits)


def _quant_weight(w, cfg: QuantConfig, channel_axis):
    if cfg.weight_quantize_type == "channel_wise_abs_max":
        return Q.fake_quant_abs_max(w, cfg.weight_bits, channel_axis)
    return Q.fake_quant_abs_max(w, cfg.weight_bits)


def _clone_as_quantized(cls, m, cfg):
    """The float layer ``m`` as its quantized subclass: the same
    attributes, parameters, buffers and children (shared, not copied),
    plus an input-activation quantizer on the weight's device."""
    q = cls.__new__(cls)
    q.__dict__.update(m.__dict__)
    for table in ("_parameters", "_buffers", "_modules"):
        q.__dict__[table] = dict(m.__dict__[table])
    q.quant_cfg = cfg
    q.input_quant = _ActQuant(cfg, device=m.weight.device)
    return q


class QuantizedLinear(L.Linear):
    """Linear with fake-quantized weight and input (ref: ``qat.py:116``).
    Weight ``[in, out]``: channel axis 1, per output channel."""
    CHANNEL_AXIS = 1

    @classmethod
    def from_float(cls, m, cfg: QuantConfig):
        return _clone_as_quantized(cls, m, cfg)

    def forward(self, x):
        w = _quant_weight(self.weight, self.quant_cfg, self.CHANNEL_AXIS)
        x = self.input_quant(x)
        y = F.matmul(x, w)
        if self.bias is not None:
            y = y + self.bias
        return L._act(self.act, y)


class QuantizedConv2D(L.Conv2D):
    """Conv2D with fake-quantized weight and input (ref: ``qat.py:137``):
    channel axis 0, per output channel of an OIHW weight, as the
    reference takes it in either layout."""
    CHANNEL_AXIS = 0

    @classmethod
    def from_float(cls, m, cfg: QuantConfig):
        return _clone_as_quantized(cls, m, cfg)

    def forward(self, x):
        w = _quant_weight(self.weight, self.quant_cfg, self.CHANNEL_AXIS)
        x = self.input_quant(x)
        y = F.conv2d(x, w, self.bias, self.stride, self.padding,
                     self.dilation, self.groups,
                     data_format=self.data_format)
        return L._act(self.act, y)


_SWAP = {L.Conv2D: QuantizedConv2D, L.Linear: QuantizedLinear}


def quantize_model(model, config: QuantConfig = None):
    """Swap every ``Linear`` and ``Conv2D`` (exactly those types) for its
    quantized version, in place in the module tree; a quantizable root
    is returned swapped (ref: ``qat.py:162``). Parameters are shared with
    the float layers; each swapped layer adds its ``input_quant``
    buffers."""
    config = config or QuantConfig()
    root_cls = _SWAP.get(type(model))
    if root_cls is not None:
        return root_cls.from_float(model, config)
    for name, child in list(model.named_children()):
        cls = _SWAP.get(type(child))
        if cls is not None:
            model._modules[name] = cls.from_float(child, config)
        else:
            quantize_model(child, config)
    return model


def upgrade_variables(qmodel, variables):
    """Load trained float variables, the JAX package's ``{"params",
    "state"}`` trees of numpy arrays, into a quantized model (ref:
    ``qat.py:185``): every parameter from ``params``, and every buffer
    ``state`` holds; the quantizer buffers it lacks keep their fresh
    values. Returns ``qmodel``."""
    from paddle_tpu_torch import bridge
    bridge.load_params(qmodel, variables["params"])
    state = bridge.flatten(variables.get("state", {}))
    own = dict(qmodel.named_buffers())
    extra = sorted(set(state) - set(own))
    enforce(not extra, f"state leaves the model does not keep: {extra[:5]}")
    with torch.no_grad():
        for name, arr in state.items():
            own[name].copy_(torch.as_tensor(arr))
    return qmodel
