"""Checkpoint publisher: any supported checkpoint -> an HF-layout directory.

Counterpart of ``midi_model_tpu/interop/publish.py``: loads a run directory
of the port's trainer (``train.checkpoint.CheckpointManager``, where the
JAX package reads orbax) or a flat ``.safetensors`` / ``.bin`` / ``.ckpt``
file, casts to fp32, fp16 or bf16, and writes ``config.json`` and
``model.safetensors`` (the port's own writer) that the reference, the JAX
package and the port load.  The JAX package's optional push to the Hugging
Face Hub needs the network and is not part of the port.

    python -m midi_model_tpu_torch.interop.publish --ckpt runs/x/checkpoints --out published
"""

from __future__ import annotations

import argparse
import os

import torch

from ..models.config import CONFIG_NAMES, MIDIModelConfig
from ..models.midinet import MIDINet

_DTYPES = {"fp32": torch.float32, "fp16": torch.float16, "bf16": torch.bfloat16}


def load_any_checkpoint(path: str, config: MIDIModelConfig, device=None) -> MIDINet:
    """The f32 model on ``device`` (None: the card) from a run directory
    (its latest save) or a flat checkpoint file."""
    from .torch_ckpt import load_state_dict, params_from_state_dict

    if os.path.isdir(path):
        from ..train.checkpoint import CheckpointManager

        sd = {n: p.numpy() for n, p in CheckpointManager(path, config).load_params().items()}
    else:
        sd = load_state_dict(path)
    return params_from_state_dict(sd, config, device=device)


def publish(ckpt: str, config_name: str, out_dir: str, dtype: str = "bf16",
            repo_id: str = "", device=None) -> str:
    """Write ``ckpt``'s weights in ``dtype`` (fp32, fp16 or bf16) and the
    config to ``out_dir``; the cast runs on ``device`` (None: the card).
    ``repo_id`` (a Hub push) raises: it needs the network."""
    if repo_id:
        raise ValueError(f"pushing to the Hugging Face Hub ({repo_id}) needs the network; "
                         "the port writes the local directory only")
    if dtype not in _DTYPES:
        raise ValueError(f"dtype {dtype!r}: one of {sorted(_DTYPES)}")
    config = (MIDIModelConfig.from_name(config_name) if config_name in CONFIG_NAMES
              else MIDIModelConfig.from_json_file(config_name))
    model = load_any_checkpoint(ckpt, config, device=device)

    from .safetensors_io import save_file

    os.makedirs(out_dir, exist_ok=True)
    tensors = {k: v.detach().to(_DTYPES[dtype]) for k, v in model.state_dict().items()}
    save_file(tensors, os.path.join(out_dir, "model.safetensors"),
              metadata={"format": "pt"} if dtype == "bf16" else None)
    config.save_pretrained(out_dir)
    return out_dir


def main(argv=None):
    ap = argparse.ArgumentParser(description="publish a checkpoint in HF layout")
    ap.add_argument("--ckpt", required=True, help="run checkpoint dir or checkpoint file")
    ap.add_argument("--config", default="tv2o-medium")
    ap.add_argument("--out", default="published")
    ap.add_argument("--dtype", default="bf16", choices=list(_DTYPES))
    ap.add_argument("--repo-id", default="",
                    help="a Hub repo to push to: refused, the port has no network push")
    ap.add_argument("--device", default=None, help="torch device (default: the card)")
    args = ap.parse_args(argv)
    out = publish(args.ckpt, args.config, args.out, args.dtype, args.repo_id,
                  device=args.device)
    print(f"published to {out}")


if __name__ == "__main__":
    main()
