"""Training on one device: data pipeline, optimizer and schedule, the
train step, checkpoints, and the CLI (``python -m
midi_model_tpu_torch.train.cli``)."""

from .data import DataLoader, MidiDataset, find_midi_files
from .sched import linear_warmup_decay
from .trainer import (
    TrainState,
    eval_step,
    init_params,
    init_train_state,
    loss_fn,
    make_optimizer,
    make_train_step,
)

__all__ = [
    "DataLoader",
    "MidiDataset",
    "TrainState",
    "eval_step",
    "find_midi_files",
    "init_params",
    "init_train_state",
    "linear_warmup_decay",
    "loss_fn",
    "make_optimizer",
    "make_train_step",
]
