"""The port's training loop, checkpointing and fault tools
(``repro.train``)."""

from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.fault import FailureInjector, StragglerMonitor
from repro_torch.train.trainer import Trainer, TrainerConfig, train_step

__all__ = [
    "CheckpointManager",
    "FailureInjector",
    "StragglerMonitor",
    "Trainer",
    "TrainerConfig",
    "train_step",
]
