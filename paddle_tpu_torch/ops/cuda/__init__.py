"""Hand-written Hopper kernels of the port, one module per TPU kernel,
each beside its plain PyTorch version. Importing them registers their
launch counters in :data:`core.KERNELS`; nothing is built until a kernel
first launches on a CUDA tensor."""

from paddle_tpu_torch.ops.cuda import (core, decode_attention,  # noqa: F401
                                       flash_attention, layer_norm, mlp,
                                       xent)
