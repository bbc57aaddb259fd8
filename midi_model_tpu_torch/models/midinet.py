"""Hierarchical MIDI model: event-level net + token-level net + shared head.

Counterpart of ``midi_model_tpu/models/midinet.py``:

- an **event** is a row of ``max_token_seq`` token ids; its embedding is the
  SUM of the row's token embeddings through the event net's table;
- the event net contextualizes event embeddings;
- the token net decodes the next row's tokens conditioned on the event
  hidden state at position 0;
- one shared ``lm_head`` projects both nets' hidden states to the vocab.

The module's own parameters do not require grad: the trainer
(``train.trainer``) keeps f32 master weights of its own and runs the module
on their compute-dtype copies (``torch.func.functional_call``).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple, Union

import torch
from torch import nn

from ..parallel.collectives import copy_to_model, gather_vocab
from .config import HybridConfig, MIDIModelConfig
from .hybrid import HybridStack
from .llama import DenseCache, LlamaStack, resolve_device


class MIDINet(nn.Module):
    """Parameters are left uninitialized: load them with
    ``interop.params_from_state_dict`` or fill them with :func:`init_model`.
    ``device=None`` is the card (``resolve_device``); the CPU runs only where
    the caller passes ``device="cpu"``."""

    def __init__(self, config: MIDIModelConfig, dtype=torch.float32,
                 device=None):
        super().__init__()
        device = resolve_device(device)
        self.config = config
        # the event net: a Llama stack, or Granite 4.0-H's hybrid stack
        # (``net_config.model_type`` granitemoehybrid)
        stack = HybridStack if isinstance(config.net, HybridConfig) else LlamaStack
        self.net = stack(config.net, dtype, device)
        self.net_token = LlamaStack(config.net_token, dtype, device)
        self.lm_head = nn.utils.skip_init(
            nn.Linear, config.n_embd, config.tokenizer.vocab_size, bias=False,
            dtype=dtype, device=device)
        self.requires_grad_(False)

    @property
    def dtype(self) -> torch.dtype:
        return self.lm_head.weight.dtype

    @property
    def device(self) -> torch.device:
        return self.lm_head.weight.device

    def embed_events(self, tokens: torch.Tensor) -> torch.Tensor:
        """[..., T] token-id rows -> [..., D] summed event embeddings (rows
        gathered, cast to the compute dtype, then summed)."""
        emb = self.net.embed_tokens(tokens.long())
        return emb.to(self.dtype).sum(dim=-2)

    def forward(self, x: torch.Tensor, cache: Optional[DenseCache] = None,
                remat: Union[bool, str] = False, tp_group=None
                ) -> Tuple[torch.Tensor, Optional[DenseCache]]:
        """Event net: ``x [B, L, T]`` -> (hidden ``[B, L, D]``, cache).
        ``tp_group``: the event net is one model shard of a Megatron split
        (``LlamaStack``); its embeddings are replicated."""
        return self.net(self.embed_events(x), cache, remat=remat, tp_group=tp_group)

    def forward_token(self, hidden_state: Optional[torch.Tensor],
                      x: Optional[torch.Tensor],
                      cache: Optional[DenseCache] = None, remat: Union[bool, str] = False,
                      tp_group=None) -> Tuple[torch.Tensor, Optional[DenseCache]]:
        """Token net + lm_head.  hidden_state [B, D] (sequence position 0) or
        None when continuing from a cache; x [B, T] token ids or None.
        Returns (logits [B, S, V] f32, cache).  ``tp_group``: the token net
        and the head are model shards too (training's split,
        ``train.sharding``): the head holds this shard's slice of the vocab
        and :meth:`logits` gathers the slices."""
        parts = []
        if hidden_state is not None:
            parts.append(hidden_state[:, None, :].to(self.dtype))
        if x is not None:
            parts.append(self.net_token.embed_tokens(x.long()).to(self.dtype))
        seq = torch.cat(parts, dim=1)
        h, cache = self.net_token(seq, cache, remat=remat, tp_group=tp_group)
        return self.logits(h, tp_group), cache

    def logits(self, hidden: torch.Tensor, tp_group=None) -> torch.Tensor:
        """The shared head in f32 (the JAX package's ``lm_head``).  Under
        ``tp_group`` the head is this shard's rows of the vocab: its f32
        logits are gathered along the vocab (the JAX split's "loss gathers
        logits"), and the replicated hidden's gradient summed over the
        group."""
        return gather_vocab(self.lm_head(copy_to_model(hidden, tp_group)).float(), tp_group)

    def train_logits(self, batch: torch.Tensor) -> "TrainOutput":
        """The training forward (``midinet.train_logits``): ``batch [B, L,
        T]`` -> next-event prediction factorized per token.  The event net
        summarizes rows 0..i; the token net, teacher-forced on row i+1's
        tokens with the event hidden prepended, predicts each of them."""
        x, y = batch[:, :-1], batch[:, 1:]
        hidden, _ = self(x)
        b, lm1, d = hidden.shape
        y = y.reshape(b * lm1, y.shape[-1])
        logits, _ = self.forward_token(hidden.reshape(b * lm1, d), y[:, :-1])
        return TrainOutput(logits=logits, targets=y)


class TrainOutput(NamedTuple):
    logits: torch.Tensor  # [B*(L-1), T, vocab] float32
    targets: torch.Tensor  # [B*(L-1), T]


def param_count(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())


@torch.no_grad()
def init_model(config: MIDIModelConfig, *, seed: int = 0,
               dtype=torch.float32, device=None) -> MIDINet:
    """Random weights made on ``device`` (None: the card) from ``seed``:
    matrices and embeddings ``N(0, initializer_range)``, norm weights 1."""
    model = MIDINet(config, dtype=dtype, device=device)
    gen = torch.Generator(device=model.device)
    gen.manual_seed(seed)
    std = config.net.initializer_range
    for name, p in model.named_parameters():
        if name.endswith("layernorm.weight") or name.endswith("norm.weight"):
            p.fill_(1.0)
        else:
            p.normal_(0.0, std, generator=gen)
    return model
