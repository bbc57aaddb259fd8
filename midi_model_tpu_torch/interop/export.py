"""Portable inference artifacts: ``torch.export`` programs of the model's steps.

Counterpart of ``midi_model_tpu/interop/export.py``, whose StableHLO
artifacts (``jax.export``) become ``torch.export`` programs saved as
``.pt2``, next to ``model.safetensors``, ``config.json`` and
``manifest.json`` (the same manifest keys).  Three programs, in the JAX
package's calling convention — the caches and a 0-d int32 ``cache_index``
go in, the new output, caches and index come out:

- ``event_forward``: tokens ``[B, 1, T]`` + the event net's cache -> hidden
  ``[B, 1, D]`` + cache;
- ``token_first``: the event hidden ``[B, D]`` + the token net's cache ->
  logits ``[B, 1, V]`` + cache (step 0 of a row);
- ``token_next``: one token id ``[B, 1]`` + the cache -> logits + cache
  (steps 1..T-1).

Each program holds only the weights it reads, cast to the export dtype, on
the device the model lives on, and runs there.  Attention is the plain
``attention_reference`` (the JAX artifacts carry no Pallas kernel either),
so a program needs only torch to load and run: ``torch.export.load``.
"""

from __future__ import annotations

import json
import os

import torch
from torch import nn

from ..models.config import MIDIModelConfig, require_llama
from ..models.llama import DenseCache
from ..models.midinet import MIDINet


class _EventForward(nn.Module):
    """The event net's step, holding only its weights."""

    def __init__(self, model: MIDINet):
        super().__init__()
        self.net = model.net

    def forward(self, tokens, cache_k, cache_v, cache_index):
        # MIDINet.embed_events: the rows' embeddings cast, then summed
        emb = self.net.embed_tokens(tokens.long()).to(cache_k.dtype).sum(dim=-2)
        hidden, cache = self.net(emb, DenseCache(cache_k, cache_v, cache_index))
        return hidden, cache.k, cache.v, cache.index


class _TokenStep(nn.Module):
    """The token net and the shared head (``MIDINet.forward_token``), from
    the event hidden (``first``) or from the previous token id."""

    def __init__(self, model: MIDINet, first: bool):
        super().__init__()
        self.net_token, self.lm_head, self.first = model.net_token, model.lm_head, first

    def forward(self, x, cache_k, cache_v, cache_index):
        seq = (x[:, None, :] if self.first else self.net_token.embed_tokens(x.long()))
        h, cache = self.net_token(seq.to(cache_k.dtype), DenseCache(cache_k, cache_v,
                                                                     cache_index))
        return self.lm_head(h).float(), cache.k, cache.v, cache.index


def export_artifacts(model: MIDINet, config: MIDIModelConfig, out_dir: str,
                     batch_size: int = 1, max_seq: int = 4096,
                     dtype=torch.bfloat16) -> dict:
    """Export the three programs at ``batch_size`` with an event cache of
    ``max_seq`` rows, weights in ``dtype`` on the model's device; write
    them with the model's weights (f32 ``model.safetensors``), the config
    and the manifest.  Returns the manifest."""
    require_llama(config, "export")
    from .safetensors_io import save_file
    from .torch_ckpt import state_dict_from_params

    os.makedirs(out_dir, exist_ok=True)
    device = model.device
    t_max = config.tokenizer.max_token_seq
    cast = MIDINet(config, dtype=dtype, device=device)
    cast.load_state_dict(model.state_dict())
    index = torch.zeros((), dtype=torch.int32, device=device)

    def caches(cfg, seq):
        cache = DenseCache.zeros(cfg, batch_size, seq, dtype, device)
        return cache.k, cache.v, index

    programs = {
        "event_forward": (_EventForward(cast), torch.zeros(
            (batch_size, 1, t_max), dtype=torch.int32, device=device), config.net, max_seq),
        "token_first": (_TokenStep(cast, first=True), torch.zeros(
            (batch_size, config.n_embd), dtype=dtype, device=device), config.net_token, t_max),
        "token_next": (_TokenStep(cast, first=False), torch.zeros(
            (batch_size, 1), dtype=torch.int32, device=device), config.net_token, t_max),
    }
    for name, (module, x, cfg, seq) in programs.items():
        program = torch.export.export(module, (x, *caches(cfg, seq)))
        torch.export.save(program, os.path.join(out_dir, f"{name}.pt2"))
    manifest = {"config": config.to_dict(),
                "functions": {"event_forward": {"tokens": [batch_size, 1, t_max],
                                                "cache_seq": max_seq},
                              "token_first": {"cache_seq": t_max},
                              "token_next": {"cache_seq": t_max}},
                "dtype": str(dtype).removeprefix("torch.")}

    save_file(state_dict_from_params(model), os.path.join(out_dir, "model.safetensors"))
    config.save_pretrained(out_dir)
    with open(os.path.join(out_dir, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=2)
    return manifest


def load_artifact(path: str):
    """One saved ``.pt2`` program (``torch.export.load``); call
    ``.module()`` on it for a callable."""
    return torch.export.load(path)


def main(argv=None):
    import argparse

    from .torch_ckpt import load_state_dict, params_from_state_dict

    ap = argparse.ArgumentParser(description="export torch.export inference programs")
    ap.add_argument("--ckpt", required=True)
    ap.add_argument("--config", default="tv2o-medium")
    ap.add_argument("--out", default="artifacts")
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--max-seq", type=int, default=4096)
    ap.add_argument("--device", default=None, help="torch device (default: the card)")
    args = ap.parse_args(argv)

    config = MIDIModelConfig.from_name(args.config)
    model = params_from_state_dict(load_state_dict(args.ckpt), config, device=args.device)
    manifest = export_artifacts(model, config, args.out, batch_size=args.batch,
                                max_seq=args.max_seq)
    print(json.dumps(manifest["functions"], indent=2))


if __name__ == "__main__":
    main()
