"""Quantization of the port (``paddle_tpu/quant``): the fake-quant and
int quantization ops, weight-only int8 serving, quantization-aware
training (``qat.py``) and post-training quantization with the int8
export (``ptq.py``)."""

from paddle_tpu_torch.quant import ops, ptq, qat  # noqa: F401
from paddle_tpu_torch.quant.ops import (abs_max_scale,  # noqa: F401
                                        dequantize_from_int,
                                        fake_quant_abs_max,
                                        fake_quant_dequant,
                                        moving_average_scale, qrange,
                                        quantize_to_int, range_abs_max_scale)
from paddle_tpu_torch.quant.ptq import (calibrate, export_int8,  # noqa: F401
                                        freeze, int8_linear,
                                        save_int8_inference_model)
from paddle_tpu_torch.quant.qat import (QuantConfig,  # noqa: F401
                                        QuantizedConv2D, QuantizedLinear,
                                        quantize_model, upgrade_variables)
from paddle_tpu_torch.quant.weight_only import \
    quantize_weights_int8  # noqa: F401

__all__ = [
    "ops", "ptq", "qat", "quantize_weights_int8", "QuantConfig",
    "QuantizedConv2D", "QuantizedLinear", "quantize_model",
    "upgrade_variables", "calibrate", "export_int8", "freeze",
    "int8_linear", "save_int8_inference_model", "fake_quant_abs_max",
    "fake_quant_dequant", "abs_max_scale", "moving_average_scale",
    "range_abs_max_scale", "quantize_to_int", "dequantize_from_int",
]
