"""Checkpoints of the port (``paddle_tpu/io``)."""
from paddle_tpu_torch.io.checkpoint import (CheckpointManager,  # noqa: F401
                                            crc_manifest, latest_step,
                                            load_persistables,
                                            save_persistables,
                                            stack_layer_tree,
                                            unstack_layer_tree)
