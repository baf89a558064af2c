"""Serving: the port's continuous-batching engine with the prefix cache,
per-request sampling, preemption and step recovery, and the fleet router
over N engine replicas."""

from paddle_tpu_torch.serving.engine import (Request,  # noqa: F401
                                             ServeConfig, ServingEngine)
from paddle_tpu_torch.serving.fleet import (  # noqa: F401
    DeployAborted, FleetConfig, FleetRequest, FleetRouter, InProcessReplica,
    ReplicaDead)
from paddle_tpu_torch.serving.prefix_cache import PrefixCache  # noqa: F401
