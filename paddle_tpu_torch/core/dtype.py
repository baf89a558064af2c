"""Canonical dtypes (ref: ``paddle_tpu/core/dtype.py:41-70``).

Maps the reference's dtype names, as a ProgramDesc's JSON attrs carry
them (``"float32"``, ``"bf16"``, ...), and numpy dtypes to torch dtypes.
"""

import numpy as np
import torch

bool_ = torch.bool
int8 = torch.int8
uint8 = torch.uint8
int16 = torch.int16
int32 = torch.int32
int64 = torch.int64
float16 = torch.float16
bfloat16 = torch.bfloat16
float32 = torch.float32
float64 = torch.float64

_STR_TO_DTYPE = {
    "bool": bool_, "int8": int8, "uint8": uint8, "int16": int16,
    "int32": int32, "int64": int64, "float16": float16, "fp16": float16,
    "bfloat16": bfloat16, "bf16": bfloat16, "float32": float32,
    "fp32": float32, "float64": float64, "fp64": float64,
}


def convert_dtype(dtype):
    """A dtype name, numpy dtype (or type) or torch dtype as a torch
    dtype; None stays None."""
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    if isinstance(dtype, str):
        key = dtype.lower()
        if key not in _STR_TO_DTYPE:
            raise TypeError(f"Unsupported dtype string: {dtype!r}")
        return _STR_TO_DTYPE[key]
    return _STR_TO_DTYPE[np.dtype(dtype).name]


def is_floating(dtype):
    return convert_dtype(dtype).is_floating_point


def is_integer(dtype):
    dt = convert_dtype(dtype)
    return not dt.is_floating_point and not dt.is_complex and dt != bool_


def finfo(dtype):
    return torch.finfo(convert_dtype(dtype))


def iinfo(dtype):
    return torch.iinfo(convert_dtype(dtype))


def numpy_dtype(dtype):
    dt = convert_dtype(dtype)
    if dt == bfloat16:
        raise TypeError("numpy has no bfloat16")
    return torch.empty((), dtype=dt).numpy().dtype
