"""Serving: the port's continuous-batching engine with the prefix cache,
per-request sampling, preemption, step recovery and prompt staging, and
the fleet router over N engine replicas, in this process or in child
processes."""

from paddle_tpu_torch.serving.engine import (Request,  # noqa: F401
                                             ServeConfig, ServingEngine)
from paddle_tpu_torch.serving.fleet import (  # noqa: F401
    DeployAborted, FleetConfig, FleetRequest, FleetRouter, InProcessReplica,
    ReplicaDead, SubprocessReplica, replica_worker_loop)
from paddle_tpu_torch.serving.prefix_cache import PrefixCache  # noqa: F401
