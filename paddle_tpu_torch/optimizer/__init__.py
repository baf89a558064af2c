"""Optimizers of the port (``paddle_tpu/optimizer``): schedules, clips,
regularizers, every optimizer and the wrappers."""
from paddle_tpu_torch.optimizer import (clip, lr_scheduler,  # noqa: F401
                                        regularizer)
from paddle_tpu_torch.optimizer.clip import (ClipByGlobalNorm,  # noqa: F401
                                             ClipByNorm, ClipByValue,
                                             global_norm)
from paddle_tpu_torch.optimizer.optimizers import (SGD,  # noqa: F401
                                                   Adadelta, Adagrad, Adam,
                                                   Adamax, AdamW,
                                                   DecayedAdagrad, Dpsgd,
                                                   Ftrl, Gate, Lamb,
                                                   LarsMomentum, Momentum,
                                                   Optimizer, RMSProp)
from paddle_tpu_torch.optimizer.regularizer import L1Decay, L2Decay  # noqa
from paddle_tpu_torch.optimizer.wrappers import (  # noqa: F401
    DGCMomentum, ExponentialMovingAverage, Lookahead, ModelAverage,
    RecomputeOptimizer)
