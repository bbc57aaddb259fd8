"""Generation from exported programs alone — the JAX package's artifact runner.

Counterpart of ``midi_model_tpu/serve/artifact_runner.py``: loads the
``torch.export`` programs written by ``interop.export`` (the event step and
``token_first`` / ``token_next`` with explicit KV caches in the calling
convention) and drives the same batch-1 generation loop from the host, with
the grammar mask tables and greedy or numpy sampling.  It is the
portability and parity check of the export path; the fast path stays
``sampling.generate``.  ``numpy_softmax`` and ``numpy_sample_top_p_k`` are
copies of the JAX module's, held equal to them by a test.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np
import torch

from ..interop.export import load_artifact
from ..models.config import MIDIModelConfig
from ..models.llama import DenseCache, resolve_device
from ..sampling.masks import build_mask_table


def numpy_softmax(x: np.ndarray) -> np.ndarray:
    x = x - x.max(axis=-1, keepdims=True)
    e = np.exp(x)
    return e / e.sum(axis=-1, keepdims=True)


def numpy_sample_top_p_k(probs: np.ndarray, top_p: float, top_k: int,
                         rng: np.random.RandomState) -> np.ndarray:
    """Reference-exact mask semantics, numpy edition (app_onnx.py:33-50)."""
    order = np.argsort(probs, axis=-1)[..., ::-1]
    sorted_probs = np.take_along_axis(probs, order, axis=-1)
    cumsum = np.cumsum(sorted_probs, axis=-1)
    keep = (cumsum - sorted_probs) <= top_p
    keep &= np.arange(probs.shape[-1]) < top_k
    filtered = np.where(keep, sorted_probs, 0.0)
    filtered = filtered / filtered.sum(axis=-1, keepdims=True)
    flat_f = filtered.reshape(-1, filtered.shape[-1])
    flat_o = order.reshape(-1, order.shape[-1])
    out = np.empty(flat_f.shape[0], dtype=np.int64)
    for i in range(flat_f.shape[0]):
        choice = rng.choice(flat_f.shape[-1], p=flat_f[i])
        out[i] = flat_o[i, choice]
    return out.reshape(probs.shape[:-1])


class ArtifactGenerator:
    """Drives generation with the exported programs only.  They run on the
    device they were exported on; ``device`` (None: the card) must be
    that one."""

    def __init__(self, artifact_dir: str, device=None):
        self.config = MIDIModelConfig.from_json_file(os.path.join(artifact_dir, "config.json"))
        programs = {name: load_artifact(os.path.join(artifact_dir, f"{name}.pt2"))
                    for name in ("event_forward", "token_first", "token_next")}
        weight = next(iter(programs["event_forward"].state_dict.values()))
        asked = resolve_device(device)
        if asked.type != weight.device.type or asked.index not in (None, weight.device.index):
            raise ValueError(f"the programs were exported for {weight.device}, not {asked}")
        self.device, self.dtype = weight.device, weight.dtype
        self.event_fn, self.token_first, self.token_next = (
            programs[name].module() for name in ("event_forward", "token_first", "token_next"))
        with open(os.path.join(artifact_dir, "manifest.json")) as f:
            self.manifest = json.load(f)

    @torch.no_grad()
    def generate(self, prompt: Optional[np.ndarray] = None, max_len: int = 64,
                 temp: float = 1.0, top_p: float = 0.98, top_k: int = 20,
                 seed: int = 0, greedy: bool = False) -> np.ndarray:
        """Host-driven loop over the exported step programs (batch 1):
        returns ``[1, L, T]`` rows, the prompt's included."""
        cfg = self.config
        tok = cfg.tokenizer
        t_max = tok.max_token_seq
        table = build_mask_table(tok)
        rng = np.random.RandomState(seed)
        max_seq = self.manifest["functions"]["event_forward"]["cache_seq"]
        dev = self.device

        def tensor(x):
            return torch.as_tensor(np.asarray(x, np.int32), device=dev)

        def cache(net_cfg, seq):
            c = DenseCache.zeros(net_cfg, 1, seq, self.dtype, dev)
            return c.k, c.v, torch.zeros((), dtype=torch.int32, device=dev)

        if prompt is None:
            prompt = np.full((1, 1, t_max), tok.pad_id, np.int32)
            prompt[0, 0, 0] = tok.bos_id
        rows = [np.asarray(r, np.int32) for r in prompt[0]]

        ck, cv, idx = cache(cfg.net, max_seq)
        hidden = None
        for r in rows:  # prefill one row at a time (the program's step is S=1)
            hidden, ck, cv, idx = self.event_fn(tensor(r.reshape(1, 1, t_max)), ck, cv, idx)

        while len(rows) < max_len:
            tck, tcv, tidx = cache(cfg.net_token, t_max)
            row = []
            ended = False
            e_off = 0
            for i in range(t_max):
                if i == 0:
                    logits, tck, tcv, tidx = self.token_first(hidden[:, -1].to(self.dtype),
                                                              tck, tcv, tidx)
                else:
                    logits, tck, tcv, tidx = self.token_next(tensor([[row[-1]]]), tck, tcv,
                                                             tidx)
                probs = numpy_softmax(logits.float().cpu().numpy()[:, -1] / temp)
                if ended:
                    mask = table.pad_only
                elif i == 0:
                    mask = table.first
                else:
                    mask = table.steps[e_off, i]
                probs = probs * mask
                if greedy:
                    t = int(np.argmax(probs[0]))
                else:
                    t = int(numpy_sample_top_p_k(probs, top_p, top_k, rng)[0])
                row.append(t)
                if i == 0:
                    if t == tok.eos_id:
                        ended = True
                    else:
                        e_off = t - (tok.eos_id + 1)
            rows.append(np.asarray(row, np.int32))
            hidden, ck, cv, idx = self.event_fn(tensor(rows[-1].reshape(1, 1, t_max)), ck,
                                                cv, idx)
            if ended:
                break
        return np.stack(rows)[None]
