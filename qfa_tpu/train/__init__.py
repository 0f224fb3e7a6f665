"""Training: reference-semantics Adam, jit epoch loop, checkpoints."""

from . import adam
from .checkpoint import latest_checkpoint, load_state, save_state
from .loop import (
    TrainConfig,
    TrainState,
    fit,
    fit_streaming,
    guard_nonfinite,
    make_epoch_fn,
    make_sliced_epoch_fn,
    make_step_fn,
    reshuffle_dataset,
    train_epoch,
)

__all__ = [
    "adam",
    "latest_checkpoint",
    "load_state",
    "save_state",
    "TrainConfig",
    "TrainState",
    "fit",
    "fit_streaming",
    "guard_nonfinite",
    "make_epoch_fn",
    "make_sliced_epoch_fn",
    "make_step_fn",
    "reshuffle_dataset",
    "train_epoch",
]
