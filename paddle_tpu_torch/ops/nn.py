"""Neural-network ops (the slice's subset of ``paddle_tpu/ops/nn.py``)."""

import torch

from paddle_tpu_torch.ops.cuda.layer_norm import layer_norm_fused


def matmul(a, b):
    """``a @ b`` with the reference's type promotion: operands of two
    floating types are both cast to ``torch.result_type(a, b)`` first, as
    jnp promotes them (an f32 activation times a bf16 weight is an f32
    product; torch's ``@`` refuses the mix). Operands of one type go to
    ``@`` as they are."""
    if a.dtype != b.dtype:
        dtype = torch.result_type(a, b)
        a, b = a.to(dtype), b.to(dtype)
    return a @ b


def layer_norm(x, scale=None, bias=None, begin_norm_axis=1, epsilon=1e-5):
    """Normalize over dims ``[begin_norm_axis:]``; scale/bias are flat over
    those dims (ref: ``paddle_tpu/ops/nn.py:361``). The K1 kernel on a
    CUDA tensor, its plain version on a CPU tensor; f32 statistics."""
    return layer_norm_fused(x, scale, bias, begin_norm_axis=begin_norm_axis,
                            epsilon=epsilon)


def lookup_table(ids, table):
    """Embedding lookup (ref: ``paddle_tpu/ops/nn.py:448``), including
    the reference's trailing-1 squeeze of the ids."""
    if ids.ndim > 1 and ids.shape[-1] == 1:
        ids = ids.squeeze(-1)
    return table[ids.long()]
