"""Ops of the port: plain PyTorch, with the hand-written kernels under
``ops/cuda``.

Submodules (the reference's ``paddle_tpu/ops`` names):
  activations   relu, sigmoid, gelu, tanh
  attention     attention, cross-attention and the paged KV cache
  crf           linear-chain CRF cost and Viterbi decoding, edit distance
  detection     box geometry, priors and anchors, NMS, matching and the
                SSD loss, RoI ops, YOLOv3, proposals and RoI targets
  fused         the fused vocab cross-entropy (vh: K5/K6; hv: chunked)
  loss          softmax and sigmoid cross entropy, smooth L1
  mask          polygon rasterization and mask labels (host numpy)
  metrics_ops   accuracy, auc, precision_recall; chunk_eval (host)
  nets          glu and the conv/pool and sequence conv/pool compositions
  nn            layer norm, embedding lookup, promoting matmul; conv2d,
                pool2d, adaptive_pool2d, batch_norm
  rnn           LSTM/GRU cells and scans, beam search
  sequence      ragged sequence ops (pools, pad/unpad, conv, ctc_align)
  text_match    match_matrix_tensor, var_conv_2d, top-k average pooling
  vision        the detection family's vision ops (PS/Pr/deformable RoI
                pools, FPN collection, focal loss, RetinaNet output)
"""

from paddle_tpu_torch.ops import (activations, attention,  # noqa: F401
                                  crf, detection, fused, loss, mask,
                                  metrics_ops, nets, nn, rnn, sequence,
                                  text_match, vision)
