"""Training on one device: data pipeline, optimizer and schedule, the
train step, checkpoints, the CLI (``python -m
midi_model_tpu_torch.train.cli``) and corpus preprocessing (``python -m
midi_model_tpu_torch.train.preprocess``).

The names below load with their module on first access, so a process that
needs only the host side (a preprocessing worker: ``preprocess`` and
``data``) does not import torch."""

import importlib

_EXPORTS = {
    "DataLoader": "data",
    "MidiDataset": "data",
    "find_midi_files": "data",
    "linear_warmup_decay": "sched",
    "TrainState": "trainer",
    "eval_step": "trainer",
    "init_params": "trainer",
    "init_train_state": "trainer",
    "loss_fn": "trainer",
    "make_optimizer": "trainer",
    "make_train_step": "trainer",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name: str):
    if name in _EXPORTS:
        return getattr(importlib.import_module(f"{__name__}.{_EXPORTS[name]}"), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
