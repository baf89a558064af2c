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
SE-ResNeXt (image classification), the MNIST book models, DeepFM and
Wide&Deep (CTR, with the sparse-row tables of ``parallel/``), the
recommender and word2vec's N-gram LM.
"""

from paddle_tpu_torch.models import (GPT, MLP, VGG,  # noqa: F401
                                     AttentionSeq2Seq, BertConfig,
                                     BertForPretraining, ConvNet, CTRConfig,
                                     DeepFM, ErnieConfig, ErnieForPretraining,
                                     GPTConfig, GPTDecoder, LinearRegression,
                                     RecConfig, RecommenderNet, ResNet,
                                     SEResNeXt, Seq2SeqConfig,
                                     SoftmaxRegression, Transformer,
                                     TransformerConfig, WideAndDeep, Word2Vec,
                                     ctr_loss, make_sparse_deepfm_train_step,
                                     resnet18, resnet50, se_resnext50, vgg16)
from paddle_tpu_torch.parallel import (FeatureTable,  # noqa: F401
                                       HostTable, ShardedHostTable,
                                       SparseTable)
