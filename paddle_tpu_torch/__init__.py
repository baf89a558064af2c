"""paddle_tpu_torch — the PyTorch/CUDA port of paddle_tpu for one NVIDIA
H100.

The JAX package ``paddle_tpu`` stays the reference; this package imports
neither it nor jax. Its layout mirrors the reference (``ops/``, ``nn/``,
``models/``, ``serving/``, ``optimizer/``, ``amp.py``), and each Pallas
kernel on the ported path is a hand-written Hopper kernel under
``ops/cuda`` (sources in ``csrc/``), beside its plain PyTorch version.
Entry points run on the card unless the caller passes ``device="cpu"``.

The models: GPT (serving and training), BERT and ERNIE (pretraining), the
NMT Transformer and the attention seq2seq (translation).
"""

from paddle_tpu_torch.models import (GPT, AttentionSeq2Seq,  # noqa: F401
                                     BertConfig, BertForPretraining,
                                     ErnieConfig, ErnieForPretraining,
                                     GPTConfig, GPTDecoder, Seq2SeqConfig,
                                     Transformer, TransformerConfig)
