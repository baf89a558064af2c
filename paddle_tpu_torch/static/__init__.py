"""The static layer of the port (``paddle_tpu/static``): the Program /
Executor surface and the op-level ProgramDesc, the Trainer and the
training guardian."""
from paddle_tpu_torch.core.program import Program, flop_estimate  # noqa
from paddle_tpu_torch.static.desc import (OpDesc,  # noqa: F401
                                          ProgramDesc, program_desc)
from paddle_tpu_torch.static.guardian import (GuardianConfig,  # noqa: F401
                                              TrainGuardian,
                                              TrainingDiverged)
from paddle_tpu_torch.static.program import (Executor,  # noqa: F401
                                             StaticProgram,
                                             program_from_fn)
from paddle_tpu_torch.static.trainer import (PREEMPTED_EXIT_CODE,  # noqa
                                             Preempted, Trainer,
                                             TrainerConfig,
                                             train_from_dataset)
