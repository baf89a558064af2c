from paddle_tpu_torch.nn.layers import (FC, GRU, LSTM, NCE,  # noqa: F401
                                        BatchNorm, BilinearTensorProduct,
                                        Conv2D, Conv2DTranspose, Conv3D,
                                        Dropout, Embedding, GroupNorm,
                                        GRUUnit, LayerNorm, Linear,
                                        MultiHeadAttention, Pool2D, PRelu,
                                        RMSNorm, RowConv, SequenceConv,
                                        SpectralNorm, TreeConv, fused_ffn,
                                        tied_vocab_head)
from paddle_tpu_torch.nn.rnn import (RNN, BeamSearchDecoder,  # noqa: F401
                                     Decoder, GRUCell, LSTMCell, RNNCell,
                                     dynamic_decode)
from paddle_tpu_torch.nn.heads import MultiBoxHead  # noqa: F401
from paddle_tpu_torch.nn.moe import MoE, top_k_gating  # noqa: F401
from paddle_tpu_torch.nn.scan import (REMAT_POLICIES,  # noqa: F401
                                      ScanLayers, apply_remat,
                                      resolve_remat)
