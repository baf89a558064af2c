"""Serving (the port's greedy continuous-batching engine)."""

from paddle_tpu_torch.serving.engine import (Request,  # noqa: F401
                                             ServeConfig, ServingEngine)
