"""Checkpoints: the train state on ``torch.save``, the config, and a
reference-layout ``model.safetensors`` export.

Counterpart of ``midi_model_tpu/train/checkpoint.py`` (orbax there): one
``step_<n>.pt`` per save holding the step, the master weights and the
optimizer state; the manager keeps the last save (the ``--resume`` point)
and the best one by validation loss (``scores.json``), and deletes the
rest.  ``config.json`` sits beside them.  The export goes through the port's
own safetensors writer (``interop.safetensors_io``), as does the peft-layout
adapter export of a LoRA run.

On a mesh (``mesh=``) every rank joins each save and export: the model
shards' blocks are gathered into the single-device layout
(``train.sharding.gather_params``), and the mesh's first rank alone writes
(the JAX package: "all processes join" the save, process 0 exports).  A
checkpoint is therefore the same file on any mesh shape and on one device,
and ``restore`` re-shards it for the mesh it runs on.
"""

from __future__ import annotations

import json
import os
import re
from typing import Optional

import torch

import torch.distributed as dist

from ..interop.safetensors_io import save_file
from ..models.config import MIDIModelConfig
from ..parallel.mesh import Mesh
from .sharding import gather_params, shard_params
from .trainer import AdamState, TrainState

_STEP_FILE = re.compile(r"^step_(\d+)\.pt$")


class CheckpointManager:
    def __init__(self, directory: str, config: MIDIModelConfig, mesh: Optional[Mesh] = None):
        self.directory = os.path.abspath(directory)
        self.config = config
        self.mesh = mesh
        if self.writes:
            os.makedirs(self.directory, exist_ok=True)
            config.save_pretrained(self.directory)
        self._barrier()
        self._scores_path = os.path.join(self.directory, "scores.json")

    @property
    def writes(self) -> bool:
        """Whether this rank writes: the mesh's first rank, or the one
        device."""
        return self.mesh is None or (self.mesh.data_rank == 0 and self.mesh.model_rank == 0)

    def _barrier(self) -> None:
        if self.mesh is not None and self.mesh.host_group is not None:
            dist.barrier(group=self.mesh.host_group)

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
        """Write the state at ``step`` (atomically) in the single-device
        layout, record ``metrics``, and keep only the last save and the best
        by ``metrics["loss"]``.  On a mesh every rank calls it."""
        blob = {"step": state.step,
                "params": {n: p.detach() for n, p in
                           gather_params(state.params, self.mesh).items()},
                "opt_count": state.opt_state.count,
                "mu": gather_params(state.opt_state.mu, self.mesh),
                "nu": gather_params(state.opt_state.nu, self.mesh)}
        if self.writes:
            self._write(step, blob, metrics)
        self._barrier()

    def _write(self, step: int, blob: dict, metrics: Optional[dict]) -> None:
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
        dtypes of ``state``'s tensors, split for this manager's mesh (the
        weights and the moments alike)."""
        blob = self._load(step)

        def like(saved: dict, template: dict) -> dict:
            saved = shard_params(saved, self.mesh)
            out = {}
            for n, t in template.items():
                if saved[n].shape != t.shape:
                    raise ValueError(f"checkpoint {n}: {tuple(saved[n].shape)} on this "
                                     f"shard, the state holds {tuple(t.shape)}")
                out[n] = saved[n].to(device=t.device, dtype=t.dtype).requires_grad_(
                    t.requires_grad)
            return out

        opt = state.opt_state
        return TrainState(step=int(blob["step"]), params=like(blob["params"], state.params),
                          opt_state=AdamState(int(blob["opt_count"]), like(blob["mu"], opt.mu),
                                              like(blob["nu"], opt.nu)))

    def export_safetensors(self, params: dict, path: Optional[str] = None) -> str:
        """Write the weights as a reference-layout f32 ``model.safetensors``
        (the port's parameter names are the reference's keys); on a mesh,
        gathered (every rank calls it) and written by the first rank."""
        path = path or os.path.join(self.directory, "model.safetensors")
        params = gather_params(params, self.mesh)
        if self.writes:
            save_file({n: p.detach().float().cpu() for n, p in params.items()}, path)
        self._barrier()
        return path

    def export_peft_adapter(self, lora: dict, rank: int = 64, alpha: float = 128.0,
                            directory: Optional[str] = None) -> str:
        """Write the adapters (``models.lora``) in peft's layout,
        ``adapter_model.safetensors`` (f32) and ``adapter_config.json``, as
        the JAX package's ``export_peft_adapter`` does; returns the
        directory (default ``<checkpoints>/adapter``)."""
        from ..models.lora import _PEFT_NAMES, lora_to_peft_state_dict

        directory = directory or os.path.join(self.directory, "adapter")
        if not self.writes:  # the adapters are replicated: the first rank writes
            self._barrier()
            return directory
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
        self._barrier()
        return directory
