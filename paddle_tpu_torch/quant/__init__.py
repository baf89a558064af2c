"""Quantization of the port (``paddle_tpu/quant``): the fake-quant and
int quantization ops, and weight-only int8 serving. QAT and PTQ
(``quant/qat.py``, ``quant/ptq.py``) are not ported."""

from paddle_tpu_torch.quant import ops  # noqa: F401
from paddle_tpu_torch.quant.ops import (abs_max_scale,  # noqa: F401
                                        dequantize_from_int,
                                        fake_quant_abs_max,
                                        fake_quant_dequant,
                                        moving_average_scale, qrange,
                                        quantize_to_int, range_abs_max_scale)
from paddle_tpu_torch.quant.weight_only import \
    quantize_weights_int8  # noqa: F401
