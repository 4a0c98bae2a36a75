"""Training stack of the port: optimizer, data, tasks, meter, watchdog and
the one-device Trainer (counterparts of ``polyaxon_tpu/train``)."""

from .data import BatchStream, DataConfig, make_batches, synthetic_lm_batches
from .metrics import ThroughputMeter
from .optimizers import OptimizerConfig, make_optimizer, make_schedule
from .tasks import LMTask, Task, task_for
from .trainer import Trainer, TrainerConfig, TrainingDivergedError, TrainState

__all__ = [
    "BatchStream", "DataConfig", "make_batches", "synthetic_lm_batches",
    "ThroughputMeter", "OptimizerConfig", "make_optimizer", "make_schedule",
    "LMTask", "Task", "task_for", "Trainer", "TrainerConfig", "TrainingDivergedError",
    "TrainState",
]
