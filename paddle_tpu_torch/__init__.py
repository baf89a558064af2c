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
recommender, word2vec's N-gram LM and skip-gram NCE (fed by
``data/formats.py`` and the native record reader of ``data/native.py``),
the SSD example's detection ops, and the sequence family (the sentiment
nets and the BiLSTM-CRF tagger over ``core/ragged.py`` and the sequence,
CRF and text-matching ops). ``distributions`` holds the reference's four
distributions, and ``ops`` registers all of the reference's op names.

The package imports its modules on first use (PEP 562): ``import
paddle_tpu_torch.io`` loads the export and checkpoint modules and the
kernels' ops, and no model code, so a process that only runs an
exported program stays that small.
"""

import importlib

#: the names the package exports, by the module that defines them
_EXPORTS = {
    "paddle_tpu_torch.models": (
        "GPT", "MLP", "VGG", "AttentionSeq2Seq", "BertConfig",
        "BertForPretraining", "BiLstmCrfTagger", "ConvNet", "CTRConfig",
        "DeepFM", "ErnieConfig", "ErnieForPretraining", "GPTConfig",
        "GPTDecoder", "LinearRegression", "RecConfig", "RecommenderNet",
        "ResNet", "SEResNeXt", "SentimentConfig", "Seq2SeqConfig",
        "SkipGramNCE", "SoftmaxRegression", "StackedLSTMSentiment",
        "TaggerConfig",
        "TextCNNSentiment", "Transformer", "TransformerConfig",
        "WideAndDeep", "Word2Vec", "ctr_loss",
        "make_sparse_deepfm_train_step", "resnet18", "resnet50",
        "se_resnext50", "sentiment_loss", "vgg16"),
    "paddle_tpu_torch.parallel": (
        "FeatureTable", "HostTable", "ShardedHostTable", "SparseTable"),
}
_WHERE = {name: mod for mod, names in _EXPORTS.items() for name in names}
__all__ = sorted(_WHERE)


def __getattr__(name):
    if name in _WHERE:
        return getattr(importlib.import_module(_WHERE[name]), name)
    try:
        return importlib.import_module(f"{__name__}.{name}")
    except ModuleNotFoundError as e:
        if e.name != f"{__name__}.{name}":
            raise
        raise AttributeError(f"module {__name__!r} has no attribute "
                             f"{name!r}") from None
