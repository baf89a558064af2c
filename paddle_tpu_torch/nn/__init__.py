from paddle_tpu_torch.nn.layers import (GRU, LSTM, Dropout,  # noqa: F401
                                        Embedding, LayerNorm, Linear,
                                        MultiHeadAttention, fused_ffn,
                                        tied_vocab_head)
from paddle_tpu_torch.nn.rnn import (RNN, BeamSearchDecoder,  # noqa: F401
                                     Decoder, GRUCell, LSTMCell, RNNCell,
                                     dynamic_decode)
