"""Training: the train step, the fault-tolerant Trainer and checkpoints."""

from . import checkpoint
from .train_lib import Trainer, clip_by_global_norm, global_norm, make_train_step

__all__ = ["Trainer", "checkpoint", "clip_by_global_norm", "global_norm", "make_train_step"]
