"""Training stack of the port: optimizers, data, tasks, meter, watchdog and
the Trainer, on one device or a mesh of processes (counterparts of
``polyaxon_tpu/train``)."""

from .data import (
    BatchStream, DataConfig, PrefetchedStream, make_batches, skip_batches,
    synthetic_image_batches, synthetic_lm_batches, synthetic_mlm_batches,
    token_file_batches,
)
from .metrics import ThroughputMeter
from .optimizers import OptimizerConfig, make_optimizer, make_schedule
from .tasks import LMTask, MLMTask, ResNetTask, Task, ViTTask, task_for
from .trainer import Trainer, TrainerConfig, TrainingDivergedError, TrainState

__all__ = [
    "BatchStream", "DataConfig", "PrefetchedStream", "make_batches", "skip_batches",
    "synthetic_image_batches", "synthetic_lm_batches", "synthetic_mlm_batches",
    "token_file_batches", "ThroughputMeter", "OptimizerConfig", "make_optimizer",
    "make_schedule", "LMTask", "MLMTask", "ResNetTask", "Task", "ViTTask", "task_for",
    "Trainer", "TrainerConfig", "TrainingDivergedError", "TrainState",
]
