"""Ops of the port: plain PyTorch, with the hand-written kernels under
``ops/cuda``.

Submodules (the reference's ``paddle_tpu/ops`` names):
  activations   relu, sigmoid, gelu, tanh
  attention     attention, cross-attention and the paged KV cache
  fused         the fused vocab cross-entropy (vh: K5/K6; hv: chunked)
  loss          softmax cross entropy (hard and soft labels)
  nn            layer norm, embedding lookup, promoting matmul; conv2d,
                pool2d, adaptive_pool2d, batch_norm
  rnn           LSTM/GRU cells and scans, beam search
"""

from paddle_tpu_torch.ops import (activations, attention,  # noqa: F401
                                  fused, loss, nn, rnn)
