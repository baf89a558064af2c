"""Serving: the port's continuous-batching engine with the prefix cache,
per-request sampling, preemption and step recovery."""

from paddle_tpu_torch.serving.engine import (Request,  # noqa: F401
                                             ServeConfig, ServingEngine)
from paddle_tpu_torch.serving.prefix_cache import PrefixCache  # noqa: F401
