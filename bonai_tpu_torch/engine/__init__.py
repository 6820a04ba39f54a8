from .checkpoint import (latest_checkpoint, load_checkpoint, provenance_meta,
                         save_checkpoint)
from .optim import apply_gradients, build_lr_schedule, build_optimizer
from .train_step import make_train_step

__all__ = ["apply_gradients", "build_lr_schedule", "build_optimizer",
           "latest_checkpoint", "load_checkpoint", "make_train_step",
           "provenance_meta", "save_checkpoint"]
