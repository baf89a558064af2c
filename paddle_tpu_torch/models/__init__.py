from paddle_tpu_torch.models.bert import (BertConfig,  # noqa: F401
                                          BertEncoder, BertForPretraining,
                                          TransformerLayer, pretrain_loss)
from paddle_tpu_torch.models.ctr import (CTRConfig,  # noqa: F401
                                         DeepFM, WideAndDeep, ctr_loss,
                                         make_sparse_deepfm_train_step)
from paddle_tpu_torch.models.ernie import (ErnieConfig,  # noqa: F401
                                           ErnieForPretraining,
                                           ernie_pretrain_loss,
                                           knowledge_mask)
from paddle_tpu_torch.models.gpt import (GPT, GPTBlock,  # noqa: F401
                                         GPTConfig, GPTDecoder)
from paddle_tpu_torch.models.mnist import (MLP, ConvNet,  # noqa: F401
                                           LinearRegression,
                                           SoftmaxRegression)
from paddle_tpu_torch.models.recommender import (  # noqa: F401
    RecConfig, RecommenderNet, rating_loss)
from paddle_tpu_torch.models.resnet import (ResNet, resnet18,  # noqa: F401
                                            resnet50)
from paddle_tpu_torch.models.sentiment import (  # noqa: F401
    SentimentConfig, StackedLSTMSentiment, TextCNNSentiment, sentiment_loss)
from paddle_tpu_torch.models.seq2seq import (AttentionSeq2Seq,  # noqa: F401
                                             Seq2SeqConfig)
from paddle_tpu_torch.models.tagging import (BiLstmCrfTagger,  # noqa: F401
                                             TaggerConfig)
from paddle_tpu_torch.models.transformer import (  # noqa: F401
    Transformer, TransformerConfig)
from paddle_tpu_torch.models.vision_cls import (VGG,  # noqa: F401
                                                SEResNeXt, se_resnext50,
                                                vgg16)
from paddle_tpu_torch.models.word2vec import (SkipGramNCE,  # noqa: F401
                                             Word2Vec, lm_loss)
