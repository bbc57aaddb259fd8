"""Checkpoints: the train state on ``torch.save``, the config, and a
reference-layout ``model.safetensors`` export.

Counterpart of ``midi_model_tpu/train/checkpoint.py`` (orbax there): one
``step_<n>.pt`` per save holding the step, the master weights and the
optimizer state; the manager keeps the last save (the ``--resume`` point)
and the best one by validation loss (``scores.json``), and deletes the
rest.  ``config.json`` sits beside them.  The export goes through the port's
own safetensors writer (``interop.safetensors_io``), as does the peft-layout
adapter export of a LoRA run.
"""

from __future__ import annotations

import json
import os
import re
from typing import Optional

import torch

from ..interop.safetensors_io import save_file
from ..models.config import MIDIModelConfig
from .trainer import AdamState, TrainState

_STEP_FILE = re.compile(r"^step_(\d+)\.pt$")


class CheckpointManager:
    def __init__(self, directory: str, config: MIDIModelConfig):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.config = config
        config.save_pretrained(self.directory)
        self._scores_path = os.path.join(self.directory, "scores.json")

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step}.pt")

    def steps(self):
        return sorted(int(m.group(1)) for m in map(_STEP_FILE.match, os.listdir(self.directory))
                      if m)

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def _scores(self) -> dict:
        if not os.path.exists(self._scores_path):
            return {}
        with open(self._scores_path) as f:
            return json.load(f)

    def save(self, step: int, state: TrainState, metrics: Optional[dict] = None):
        """Write the state at ``step`` (atomically), record ``metrics``, and
        keep only the last save and the best by ``metrics["loss"]``."""
        blob = {"step": state.step,
                "params": {n: p.detach() for n, p in state.params.items()},
                "opt_count": state.opt_state.count,
                "mu": state.opt_state.mu, "nu": state.opt_state.nu}
        tmp = self._path(step) + ".tmp"
        torch.save(blob, tmp)
        os.replace(tmp, self._path(step))
        scores = self._scores()
        if metrics:
            scores[str(step)] = {k: float(v) for k, v in metrics.items()}
            with open(self._scores_path, "w") as f:
                json.dump(scores, f)
        keep = {step}
        scored = [(v["loss"], int(k)) for k, v in scores.items()
                  if "loss" in v and os.path.exists(self._path(int(k)))]
        if scored:
            keep.add(min(scored)[1])
        for old in self.steps():
            if old not in keep:
                os.remove(self._path(old))

    def _load(self, step: Optional[int]) -> dict:
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        return torch.load(self._path(step), map_location="cpu", weights_only=True)

    def load_params(self, step: Optional[int] = None) -> dict:
        """The weights saved at ``step`` (default: the latest), f32 on the CPU,
        without an optimizer state to restore into (``interop.publish``)."""
        return self._load(step)["params"]

    def restore(self, state: TrainState, step: Optional[int] = None) -> TrainState:
        """The saved state at ``step`` (default: the latest) on the devices and
        dtypes of ``state``'s tensors."""
        blob = self._load(step)

        def like(saved: dict, template: dict) -> dict:
            return {n: saved[n].to(device=t.device, dtype=t.dtype).requires_grad_(t.requires_grad)
                    for n, t in template.items()}

        opt = state.opt_state
        return TrainState(step=int(blob["step"]), params=like(blob["params"], state.params),
                          opt_state=AdamState(int(blob["opt_count"]), like(blob["mu"], opt.mu),
                                              like(blob["nu"], opt.nu)))

    def export_safetensors(self, params: dict, path: Optional[str] = None) -> str:
        """Write the weights as a reference-layout f32 ``model.safetensors``
        (the port's parameter names are the reference's keys)."""
        path = path or os.path.join(self.directory, "model.safetensors")
        save_file({n: p.detach().float().cpu() for n, p in params.items()}, path)
        return path

    def export_peft_adapter(self, lora: dict, rank: int = 64, alpha: float = 128.0,
                            directory: Optional[str] = None) -> str:
        """Write the adapters (``models.lora``) in peft's layout,
        ``adapter_model.safetensors`` (f32) and ``adapter_config.json``, as
        the JAX package's ``export_peft_adapter`` does; returns the
        directory (default ``<checkpoints>/adapter``)."""
        from ..models.lora import _PEFT_NAMES, lora_to_peft_state_dict

        directory = directory or os.path.join(self.directory, "adapter")
        os.makedirs(directory, exist_ok=True)
        save_file(lora_to_peft_state_dict(lora),
                  os.path.join(directory, "adapter_model.safetensors"))
        adapter_config = {
            "peft_type": "LORA",
            "task_type": None,
            "r": rank,
            "lora_alpha": alpha,
            "lora_dropout": 0.0,
            "bias": "none",
            "fan_in_fan_out": False,
            # peft matches module-name suffixes
            "target_modules": sorted({v.split(".")[-1] for v in _PEFT_NAMES.values()}),
        }
        with open(os.path.join(directory, "adapter_config.json"), "w") as f:
            json.dump(adapter_config, f, indent=2)
        return directory
