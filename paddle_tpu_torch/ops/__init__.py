"""Ops of the port: plain PyTorch, with the hand-written kernels under
``ops/cuda``. Every public op is registered by the reference's name in
``core/registry.py``'s ``GLOBAL_OP_REGISTRY``, so a ProgramDesc
(``static/desc.py``) can name it; the aliases are added once every module
has imported, as the reference's ``ops/__init__.py:50-51`` adds them.

Submodules (the reference's ``paddle_tpu/ops`` names):
  activations   relu ... maxout: the reference's 26 activations
  attention     attention, cross-attention and the paged KV cache
  control_flow  loops, conditionals, scan, the functional TensorArray
  crf           linear-chain CRF cost and Viterbi decoding, edit distance
  detection     box geometry, priors and anchors, NMS, matching and the
                SSD loss, RoI ops, YOLOv3, proposals and RoI targets
  fused         the fused vocab cross-entropy (vh: K5/K6; hv: chunked)
                and the reference's fused compositions (the fc + add +
                layer norm: K8)
  graph         tree convolution (TBCNN) and its host-built coefficients
  loss          the reference's 23 losses
  mask          polygon rasterization and mask labels (host numpy)
  math          matmul/mul, elementwise_*, unary math, reductions, norms
  metrics_ops   accuracy, auc, precision_recall; chunk_eval (host)
  nets          glu and the conv/pool and sequence conv/pool compositions
  nn            fc, convs, pools, norms (layer norm: K1), dropout,
                embedding lookup, resize, unfold; the promoting matmul
  rnn           LSTM/GRU cells and scans, beam search
  sequence      ragged sequence ops (pools, pad/unpad, conv, ctc_align)
  tail          the rest of layers/nn.py's surface and the reference's
                alias table
  tensor_ops    shape, index, creation, comparison and random ops
  text_match    match_matrix_tensor, var_conv_2d, top-k average pooling
  vision        sampling grids, deformable conv, 3-D pools and transposed
                conv, max pool with index and unpool, spp, data_norm,
                channel/depth/temporal shuffles, and the detection
                family's vision ops
"""

from paddle_tpu_torch.core.registry import GLOBAL_OP_REGISTRY
from paddle_tpu_torch.ops import (activations, attention,  # noqa: F401
                                  control_flow, crf, detection, fused, graph,
                                  loss,
                                  mask, math, metrics_ops, nets, nn, rnn,
                                  sequence, tail, tensor_ops, text_match,
                                  vision)

tail.register_reference_aliases()
fused.register_fused_aliases()


def list_ops():
    """Every registered op name."""
    return GLOBAL_OP_REGISTRY.list_ops()
