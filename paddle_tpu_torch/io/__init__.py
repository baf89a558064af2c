"""Checkpoints and inference export of the port (``paddle_tpu/io``)."""
from paddle_tpu_torch.io.checkpoint import (CheckpointManager,  # noqa: F401
                                            crc_manifest, latest_step,
                                            load_persistables,
                                            save_persistables,
                                            stack_layer_tree,
                                            unstack_layer_tree)
from paddle_tpu_torch.io.inference import (Predictor,  # noqa: F401
                                           load_inference_model,
                                           load_program,
                                           read_params_bin,
                                           save_inference_model,
                                           save_train_program)
