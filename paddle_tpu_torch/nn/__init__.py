from paddle_tpu_torch.nn.layers import (Dropout, Embedding,  # noqa: F401
                                        LayerNorm, Linear,
                                        MultiHeadAttention, fused_ffn,
                                        tied_vocab_head)
