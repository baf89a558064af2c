from paddle_tpu_torch.models.gpt import (GPT, GPTBlock,  # noqa: F401
                                         GPTConfig, GPTDecoder)
