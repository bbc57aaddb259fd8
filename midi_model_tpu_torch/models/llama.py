"""Llama-style decoder stack as PyTorch modules.

Counterpart of ``midi_model_tpu/models/llama.py`` with the same numerics
(HF-Llama semantics):

- RMSNorm in float32, weight applied after the cast back (eps 1e-6 default);
- rotary embeddings in the "rotate_half" layout, angles in float32;
- attention scores scaled by ``head_dim**-0.5`` with a float32 softmax;
- SwiGLU MLP ``down(silu(gate(x)) * up(x))``; no biases anywhere;
- matmul outputs in the weight dtype.

Module and parameter names follow the reference state dict
(``layers.{i}.self_attn.q_proj.weight`` ...), so a reference checkpoint
loads with ``load_state_dict``.  Weights are torch ``[out, in]`` matrices.

Three ways through the stack:

- :meth:`LlamaStack.forward` — no cache (causal attention kernel on CUDA),
  or a small dense cache (the 8-position token net);
- :meth:`LlamaStack.prefill_paged` — a whole prompt, K/V written straight
  into paged pools (``ops.paged_allheads`` layout);
- :meth:`LlamaStack.decode_paged` — one token per slot over the pools, with
  the fresh token's own attention term merged in f32.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import paged_allheads as pa
from ..ops.attention import attention_reference, causal_attention
from .config import TransformerConfig


def _linear(n_in: int, n_out: int, dtype, device) -> nn.Linear:
    return nn.utils.skip_init(nn.Linear, n_in, n_out, bias=False,
                              dtype=dtype, device=device)


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    xf = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return weight * xf.to(x.dtype)


def rope_cos_sin(positions: torch.Tensor, head_dim: int, theta: float
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables for the given positions; float32, shape [..., head_dim]."""
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=positions.device) / head_dim
    inv_freq = 1.0 / (theta ** exponent)
    freqs = positions.float()[..., None] * inv_freq
    emb = torch.cat([freqs, freqs], dim=-1)
    return torch.cos(emb), torch.sin(emb)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
               ) -> torch.Tensor:
    """x: [B, S, H, Dh]; cos/sin: [S, Dh] or [B, S, Dh] (float32)."""
    if cos.ndim == 2:
        cos, sin = cos[None], sin[None]
    cos, sin = cos[:, :, None, :], sin[:, :, None, :]
    x1, x2 = x.chunk(2, dim=-1)
    rotated = torch.cat([-x2, x1], dim=-1)
    return (x.float() * cos + rotated.float() * sin).to(x.dtype)


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float, dtype, device):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim, dtype=dtype, device=device))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return rms_norm(x, self.weight, self.eps)


class Attention(nn.Module):
    def __init__(self, cfg: TransformerConfig, dtype, device):
        super().__init__()
        d, dh = cfg.hidden_size, cfg.head_dim
        self.q_proj = _linear(d, cfg.num_heads * dh, dtype, device)
        self.k_proj = _linear(d, cfg.kv_heads * dh, dtype, device)
        self.v_proj = _linear(d, cfg.kv_heads * dh, dtype, device)
        self.o_proj = _linear(cfg.num_heads * dh, d, dtype, device)


class MLP(nn.Module):
    def __init__(self, cfg: TransformerConfig, dtype, device):
        super().__init__()
        d, f = cfg.hidden_size, cfg.intermediate_size
        self.gate_proj = _linear(d, f, dtype, device)
        self.up_proj = _linear(d, f, dtype, device)
        self.down_proj = _linear(f, d, dtype, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


class LlamaLayer(nn.Module):
    """One decoder layer; the stack's three paths differ only in attention,
    so the layer exposes the parts before (:meth:`qkv`) and after
    (:meth:`finish`) it."""

    def __init__(self, cfg: TransformerConfig, dtype, device):
        super().__init__()
        self.cfg = cfg
        self.self_attn = Attention(cfg, dtype, device)
        self.mlp = MLP(cfg, dtype, device)
        self.input_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps,
                                       dtype, device)
        self.post_attention_layernorm = RMSNorm(
            cfg.hidden_size, cfg.rms_norm_eps, dtype, device)

    def qkv(self, x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
        """x [B, S, D] -> roped q [B,S,H,Dh], k [B,S,Hkv,Dh], v [B,S,Hkv,Dh]."""
        b, s, _ = x.shape
        cfg = self.cfg
        hc = self.input_layernorm(x)
        q = self.self_attn.q_proj(hc).view(b, s, cfg.num_heads, cfg.head_dim)
        k = self.self_attn.k_proj(hc).view(b, s, cfg.kv_heads, cfg.head_dim)
        v = self.self_attn.v_proj(hc).view(b, s, cfg.kv_heads, cfg.head_dim)
        return apply_rope(q, cos, sin), apply_rope(k, cos, sin), v

    def finish(self, x: torch.Tensor, attn: torch.Tensor) -> torch.Tensor:
        """Residual o-projection then the residual MLP; attn [..., H*Dh]."""
        x = x + self.self_attn.o_proj(attn)
        return x + self.mlp(self.post_attention_layernorm(x))


class DenseCache(NamedTuple):
    """Small dense KV cache ``k, v: [L, B, T, Hkv, Dh]`` with an aligned
    write index (the token net's 8 positions)."""

    k: torch.Tensor
    v: torch.Tensor
    index: int

    @staticmethod
    def zeros(cfg: TransformerConfig, batch: int, max_seq: int, dtype,
              device) -> "DenseCache":
        shape = (cfg.num_layers, batch, max_seq, cfg.kv_heads, cfg.head_dim)
        return DenseCache(torch.zeros(shape, dtype=dtype, device=device),
                          torch.zeros(shape, dtype=dtype, device=device), 0)


class LlamaStack(nn.Module):
    def __init__(self, cfg: TransformerConfig, dtype=torch.float32,
                 device=None):
        super().__init__()
        device = torch.device("cpu" if device is None else device)
        self.cfg = cfg
        self.embed_tokens = nn.utils.skip_init(
            nn.Embedding, cfg.vocab_size, cfg.hidden_size, dtype=dtype,
            device=device)
        self.layers = nn.ModuleList(
            LlamaLayer(cfg, dtype, device) for _ in range(cfg.num_layers))
        self.norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, dtype, device)

    def forward(self, emb: torch.Tensor, cache: Optional[DenseCache] = None
                ) -> Tuple[torch.Tensor, Optional[DenseCache]]:
        """``emb [B, S, D]`` -> (hidden after the final norm, cache).

        Without a cache: causal self-attention over the S rows.  With one:
        positions start at ``cache.index``, the new K/V are written into the
        cache in place and attention spans all cached positions."""
        b, s, _ = emb.shape
        cfg = self.cfg
        start = 0 if cache is None else cache.index
        positions = torch.arange(start, start + s, device=emb.device)
        cos, sin = rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta)
        if cache is not None:
            k_pos = torch.arange(cache.k.shape[2], device=emb.device)
            bias = torch.where(k_pos[None, :] <= positions[:, None], 0.0,
                               -torch.inf)[None, None]
        x = emb
        for li, layer in enumerate(self.layers):
            q, k, v = layer.qkv(x, cos, sin)
            if cache is None:
                attn = causal_attention(q, k, v)
            else:
                cache.k[li, :, start:start + s] = k
                cache.v[li, :, start:start + s] = v
                attn = attention_reference(q, cache.k[li], cache.v[li], bias)
            x = layer.finish(x, attn.reshape(b, s, -1))
        if cache is not None:
            cache = cache._replace(index=start + s)
        return self.norm(x), cache

    def prefill_paged(self, emb: torch.Tensor, pools: pa.PagedPools, *,
                      page_size: int, pages_per_slot: int
                      ) -> Tuple[torch.Tensor, pa.PagedPools]:
        """Run the stack over a whole prompt ``emb [B, S, D]``, writing each
        layer's packed K/V straight into its pages of the pools (in place;
        rows past S in the written pages are zero).  Returns (hidden [B, S, D]
        after the final norm, pools)."""
        b, s, _ = emb.shape
        cfg = self.cfg
        n_layers, ps = cfg.num_layers, page_size
        if pools.k.shape[0] != n_layers * b * pages_per_slot:
            raise ValueError(f"pools hold {pools.k.shape[0]} pages, expected "
                             f"{n_layers * b * pages_per_slot}")
        n_pre = -(-s // ps)
        positions = torch.arange(s, device=emb.device)
        cos, sin = rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta)
        width = pools.k.shape[-1]
        k4 = pools.k.view(n_layers * b, pages_per_slot, ps, width)
        v4 = pools.v.view(n_layers * b, pages_per_slot, ps, width)

        def write(buf4, x, li):  # [B, S, Hkv, Dh] -> this layer's pages
            flat = pa.pack_heads(x, cfg.kv_heads, cfg.head_dim)
            flat = F.pad(flat, (0, 0, 0, n_pre * ps - s))
            buf4[li * b:(li + 1) * b, :n_pre] = flat.view(b, n_pre, ps, width)

        x = emb
        for li, layer in enumerate(self.layers):
            q, k, v = layer.qkv(x, cos, sin)
            attn = causal_attention(q, k, v)
            x = layer.finish(x, attn.reshape(b, s, -1))
            write(k4, k, li)
            write(v4, v, li)
        return self.norm(x), pools

    def decode_paged(self, x: torch.Tensor, pools: pa.PagedPools,
                     index: torch.Tensor, *, page_size: int,
                     pages_per_slot: int
                     ) -> Tuple[torch.Tensor, pa.PagedPools]:
        """One-token decode step over paged pools.

        x: [B, D] input embeddings; index: int [B] per-slot lengths BEFORE
        this token.  The paged kernel attends the cached history and appends
        the fresh row (rows at capacity are written to the last position);
        the fresh token's own term merges analytically in f32 from the
        (o, m, l) stats — for a length-0 slot (m = -inf, l = 0) that is
        exactly the self attention.  Returns (hidden [B, D], pools)."""
        b, _ = x.shape
        cfg = self.cfg
        h, hkv, dh = cfg.num_heads, cfg.kv_heads, cfg.head_dim
        groups = h // hkv
        capacity = pages_per_slot * page_size
        index = index.to(torch.int32)
        write_pos = index.clamp(0, capacity - 1)
        lengths = index.clamp(max=capacity)
        write_offs = write_pos % page_size
        cos, sin = rope_cos_sin(index[:, None], dh, cfg.rope_theta)  # [B,1,Dh]
        scale = dh ** -0.5
        slots = torch.arange(b, dtype=torch.int32, device=x.device)

        for li, layer in enumerate(self.layers):
            q, k, v = layer.qkv(x[:, None, :], cos, sin)
            k, v = k[:, 0], v[:, 0]  # [B, Hkv, Dh]
            base_pages = (li * b + slots) * pages_per_slot
            # q pre-scaled in f32 (the kernel does no scaling)
            qs = q[:, 0].float() * scale
            write = (pa.pack_heads(k, hkv, dh).contiguous(),
                     pa.pack_heads(v, hkv, dh).contiguous(),
                     base_pages + write_pos // page_size, write_offs)
            o, m, l, pools = pa.paged_attention_stats(
                qs, pools, lengths, base_pages, write, page_size=page_size,
                pages_per_slot=pages_per_slot, kv_heads=hkv, head_dim=dh)

            k_rep = k.float().repeat_interleave(groups, dim=1)  # [B, H, Dh]
            v_rep = v.float().repeat_interleave(groups, dim=1)
            s_self = torch.sum(qs * k_rep, dim=-1)  # [B, H]
            m2 = torch.maximum(m, s_self)
            w_cache = l * torch.exp(m - m2)
            w_self = torch.exp(s_self - m2)
            attn = ((w_cache[..., None] * o + w_self[..., None] * v_rep)
                    / (w_cache + w_self)[..., None])
            x = layer.finish(x, attn.reshape(b, h * dh).to(x.dtype))
        return self.norm(x), pools
