"""The training runtime of the port (``paddle_tpu/static``): the Trainer
and the training guardian."""
from paddle_tpu_torch.static.guardian import (GuardianConfig,  # noqa: F401
                                              TrainGuardian,
                                              TrainingDiverged)
from paddle_tpu_torch.static.trainer import (PREEMPTED_EXIT_CODE,  # noqa
                                             Preempted, Trainer,
                                             TrainerConfig,
                                             train_from_dataset)
