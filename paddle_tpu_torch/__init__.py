"""paddle_tpu_torch — the PyTorch/CUDA port of paddle_tpu for one NVIDIA
H100.

The JAX package ``paddle_tpu`` stays the reference; this package imports
neither it nor jax. Its layout mirrors the reference (``ops/``, ``nn/``,
``models/``, ``serving/``, ``optimizer/``, ``amp.py``), and each Pallas
kernel on the ported path is a hand-written Hopper kernel under
``ops/cuda`` (sources in ``csrc/``), beside its plain PyTorch version.
Entry points run on the card unless the caller passes ``device="cpu"``.

The models: GPT (serving and training), BERT and ERNIE (pretraining), the
NMT Transformer and the attention seq2seq (translation), ResNet, VGG and
SE-ResNeXt (image classification) and the MNIST book models.
"""

from paddle_tpu_torch.models import (GPT, MLP, VGG,  # noqa: F401
                                     AttentionSeq2Seq, BertConfig,
                                     BertForPretraining, ConvNet,
                                     ErnieConfig, ErnieForPretraining,
                                     GPTConfig, GPTDecoder, LinearRegression,
                                     ResNet, SEResNeXt, Seq2SeqConfig,
                                     SoftmaxRegression, Transformer,
                                     TransformerConfig, resnet18, resnet50,
                                     se_resnext50, vgg16)
