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

- :meth:`LlamaStack.forward` — no cache (causal attention kernel on CUDA,
  differentiable: the training forward, with selective recompute), or a
  small dense cache (the 8-position token net, and the exported programs);
- :meth:`LlamaStack.prefill_paged` — a whole prompt, K/V written straight
  into paged pools (``ops.paged_allheads`` layout);
- :meth:`LlamaStack.decode_paged` — one token per slot over the pools, with
  the fresh token's own attention term merged in f32.

Each takes an optional ``tp_group``: the stack is then one model shard of a
Megatron split (``sampling.sharded.tp_shard_params`` for serving,
``train.sharding.shard_params`` for training) — q/k/v, gate and up hold
this shard's heads and MLP slice, o_proj and down its rows — and
:meth:`LlamaLayer.finish` sums the two row-parallel products over the group
(``parallel.reduce_from_model``) before each residual add.  Under autograd
the normed inputs of the column-parallel products go through
``parallel.copy_to_model``, whose backward sums their gradient over the
group; under ``no_grad`` both are what serving runs (the identity, and
``parallel.all_reduce_sum`` in place).  Without one, the code and its
results are those of one device.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple, Union

import torch
import torch.nn.functional as F
import torch.func
import torch.utils.checkpoint
from torch import nn

from ..ops import paged_allheads as pa
from ..ops.attention import attention_reference, causal_attention
from ..parallel.collectives import copy_to_model, reduce_from_model
from .config import TransformerConfig


def resolve_device(device=None) -> torch.device:
    """``device``, or the card when it is None.  The port runs on the CPU
    only where the caller asks for it: with no device named and no card,
    raise instead of carrying on quietly on the CPU."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run the "
                           "port's plain versions on the CPU")
    return torch.device("cuda")


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

    def qkv(self, x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor, tp_group=None):
        """x [B, S, D] -> roped q [B,S,H,Dh], k [B,S,Hkv,Dh], v [B,S,Hkv,Dh]."""
        b, s, _ = x.shape
        cfg = self.cfg
        hc = copy_to_model(self.input_layernorm(x), tp_group)
        q = self.self_attn.q_proj(hc).view(b, s, cfg.num_heads, cfg.head_dim)
        k = self.self_attn.k_proj(hc).view(b, s, cfg.kv_heads, cfg.head_dim)
        v = self.self_attn.v_proj(hc).view(b, s, cfg.kv_heads, cfg.head_dim)
        return apply_rope(q, cos, sin), apply_rope(k, cos, sin), v

    def finish(self, x: torch.Tensor, attn: torch.Tensor, tp_group=None) -> torch.Tensor:
        """Residual o-projection then the residual MLP; attn [..., H*Dh].
        Under ``tp_group`` each row-parallel product is summed over the
        model shards before its residual add."""
        x = x + reduce_from_model(self.self_attn.o_proj(attn), tp_group)
        h = copy_to_model(self.post_attention_layernorm(x), tp_group)
        return x + reduce_from_model(self.mlp(h), tp_group)

    def forward(self, x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
                tp_group=None) -> torch.Tensor:
        """The cacheless layer: causal self-attention over x [B, S, D]."""
        b, s, _ = x.shape
        q, k, v = self.qkv(x, cos, sin, tp_group)
        return self.finish(x, causal_attention(q, k, v).reshape(b, s, -1), tp_group)


# ``--remat`` policies: what each saves of a layer's forward for its
# backward (the JAX package's ``jax.checkpoint`` policies); the rest is
# recomputed.  "full" saves nothing but the layer's input; "dots" the outputs
# of its projection products (``dots_with_no_batch_dims_saveable``: norms,
# RoPE, SwiGLU and attention recomputed); "dots_all" also the attention
# forward's output and log-sum-exp (``dots_saveable``: JAX's attention
# einsums are dots).  The attention kernel is named through its operator
# (``ops.attention.causal_attention_forward``), as a policy sees only the
# dispatcher's operators.
_MATMULS = (torch.ops.aten.mm, torch.ops.aten.addmm, torch.ops.aten.linear)
REMAT_SAVES = {"full": (), "dots": _MATMULS,
               "dots_all": _MATMULS + (torch.ops.midi_model_tpu_torch.causal_attention_forward,)}


def remat_policy(remat: Union[bool, str]) -> Optional[str]:
    """``remat`` as one of :data:`REMAT_SAVES`'s keys, or None for no
    recompute: True is "full", a false value none."""
    if remat is True:
        return "full"
    if not remat:
        return None
    if remat not in REMAT_SAVES:
        raise ValueError(f"remat {remat!r}: one of {sorted(REMAT_SAVES)}")
    return remat


def _saving(saved):
    """A ``context_fn`` for ``torch.utils.checkpoint``: keep the outputs of
    the ``saved`` operators, recompute the rest."""
    from torch.utils.checkpoint import CheckpointPolicy, create_selective_checkpoint_contexts

    def policy(ctx, op, *args, **kwargs):
        return (CheckpointPolicy.MUST_SAVE if op.overloadpacket in saved
                else CheckpointPolicy.PREFER_RECOMPUTE)

    return create_selective_checkpoint_contexts(policy)


def _recomputed(layer: LlamaLayer, x: torch.Tensor, cos: torch.Tensor,
                sin: torch.Tensor, policy: str, tp_group=None) -> torch.Tensor:
    """``layer(x)`` under ``torch.utils.checkpoint``, recomputed in the
    backward but for what ``policy`` (a key of :data:`REMAT_SAVES`) saves.
    The layer's weights go in as inputs and the recompute binds them again:
    under ``torch.func.functional_call`` (the trainer's cast weights) they
    are not the module's own once the call has returned.  Under
    ``tp_group`` the recompute replays the layer's all-reduces: every model
    shard recomputes the same layers in the same order, so they pair up."""
    names, weights = zip(*layer.named_parameters())
    saved = REMAT_SAVES[policy]

    def run(x, *weights):
        return torch.func.functional_call(layer, dict(zip(names, weights)), (x, cos, sin),
                                          {"tp_group": tp_group})

    context = (functools.partial(_saving, saved) if saved
               else torch.utils.checkpoint.noop_context_fn)
    return torch.utils.checkpoint.checkpoint(run, x, *weights, use_reentrant=False,
                                             context_fn=context)


class DenseCache(NamedTuple):
    """Small dense KV cache ``k, v: [L, B, T, Hkv, Dh]`` with an aligned
    write index: an int, or a 0-d integer tensor (the exported programs'
    calling convention, ``interop.export``)."""

    k: torch.Tensor
    v: torch.Tensor
    index: Union[int, torch.Tensor]

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
        device = resolve_device(device)
        self.cfg = cfg
        self.embed_tokens = nn.utils.skip_init(
            nn.Embedding, cfg.vocab_size, cfg.hidden_size, dtype=dtype,
            device=device)
        self.layers = nn.ModuleList(
            LlamaLayer(cfg, dtype, device) for _ in range(cfg.num_layers))
        self.norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, dtype, device)

    def forward(self, emb: torch.Tensor, cache: Optional[DenseCache] = None,
                remat: Union[bool, str] = False, tp_group=None
                ) -> Tuple[torch.Tensor, Optional[DenseCache]]:
        """``emb [B, S, D]`` -> (hidden after the final norm, cache).

        Without a cache: causal self-attention over the S rows — the
        training forward (``causal_attention`` is differentiable; the pools
        of the paged paths are written in place and are not).  With one:
        positions start at ``cache.index`` (an int or a 0-d tensor), the new
        K/V are written into copies of the cache's layers (``index_copy``:
        shapes that do not depend on the index, so the step exports) and
        attention spans all cached positions; the returned cache holds them
        and ``index + S``.

        ``remat`` (cacheless only): each layer runs under
        ``torch.utils.checkpoint`` and is recomputed in the backward, but
        for what the policy saves (:func:`remat_policy`: True or "full" the
        JAX package's ``remat=True``, "dots" / "dots_all" its selective
        policies; with a ``tp_group`` too)."""
        b, s, _ = emb.shape
        cfg = self.cfg
        policy = remat_policy(remat)
        start = 0 if cache is None else cache.index
        positions = start + torch.arange(s, device=emb.device)
        cos, sin = rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta)
        if cache is not None:
            if policy:
                raise ValueError("remat applies to the cacheless forward only")
            k_pos = torch.arange(cache.k.shape[2], device=emb.device)
            bias = torch.where(k_pos[None, :] <= positions[:, None], 0.0,
                               -torch.inf)[None, None]
            ks, vs = [], []

        x = emb
        for li, layer in enumerate(self.layers):
            if cache is None:
                x = (_recomputed(layer, x, cos, sin, policy, tp_group) if policy
                     else layer(x, cos, sin, tp_group))
            else:
                q, k, v = layer.qkv(x, cos, sin, tp_group)
                ks.append(cache.k[li].index_copy(1, positions, k))
                vs.append(cache.v[li].index_copy(1, positions, v))
                attn = attention_reference(q, ks[-1], vs[-1], bias)
                x = layer.finish(x, attn.reshape(b, s, -1), tp_group)
        if cache is not None:  # (a stack of no layers keeps its empty cache)
            cache = DenseCache(torch.stack(ks) if ks else cache.k,
                               torch.stack(vs) if vs else cache.v, start + s)
        return self.norm(x), cache

    def alloc_storage(self, slots: int, pages_per_slot: int, page_size: int,
                      kv_int8: bool = False) -> pa.PagedPools:
        """The stack's per-slot storage, as ``HybridStack``'s: zeroed pools
        for ``slots`` slots, of the model dtype or int8."""
        cfg, weight = self.cfg, self.norm.weight
        return pa.alloc_pools(cfg.kv_heads, cfg.num_layers * slots * pages_per_slot, page_size,
                              cfg.head_dim, weight.dtype, weight.device, quantized=kv_int8)

    def prefill_paged(self, emb: torch.Tensor, pools: pa.PagedPools, *,
                      page_size: int, pages_per_slot: int,
                      slots: Optional[torch.Tensor] = None,
                      n_slots: Optional[int] = None, lengths=None, tp_group=None
                      ) -> Tuple[torch.Tensor, pa.PagedPools]:
        """Run the stack over whole prompts ``emb [G, S, D]``, writing each
        layer's packed K/V straight into its pages of the pools (in place;
        quantized per token and head for int8 pools).  Prompt ``g`` goes to
        slot ``slots[g]`` of a pool laid out for ``n_slots`` slots (page
        ``(li*n_slots + slot) * pages_per_slot``); by default slot ``g`` of
        ``G``.  Rows past S in the written pages are zero, and at most
        ``pages_per_slot`` pages are written; ``lengths`` goes unread (pad
        rows follow their prompt's).  Returns (hidden [G, S, D] after the
        final norm, pools)."""
        g_n, s, _ = emb.shape
        cfg = self.cfg
        n_layers, ps = cfg.num_layers, page_size
        if slots is None:
            slots = torch.arange(g_n, device=emb.device)
            n_slots = g_n
        if pools.k.shape[0] != n_layers * n_slots * pages_per_slot:
            raise ValueError(f"pools hold {pools.k.shape[0]} pages, expected "
                             f"{n_layers * n_slots * pages_per_slot}")
        n_pre = min(-(-s // ps), pages_per_slot)
        rows = n_pre * ps
        positions = torch.arange(s, device=emb.device)
        cos, sin = rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta)
        hkv, dh = cfg.kv_heads, cfg.head_dim
        page = (slots.long()[:, None] * pages_per_slot
                + torch.arange(n_pre, device=emb.device)[None, :])  # [G, n_pre]

        def write(buf, flat, li):  # flat [G, S, w] -> this layer's pages
            flat = F.pad(flat, (0, 0, 0, max(rows - s, 0)))[:, :rows]
            buf[li * n_slots * pages_per_slot + page] = flat.reshape(
                g_n, n_pre, ps, flat.shape[-1]).to(buf.dtype)

        x = emb
        for li, layer in enumerate(self.layers):
            q, k, v = layer.qkv(x, cos, sin)
            attn = causal_attention(q, k, v)
            x = layer.finish(x, attn.reshape(g_n, s, -1), tp_group)
            if pools.quantized:
                kq, k_scale = pa.quantize_packed(k, hkv, dh)
                vq, v_scale = pa.quantize_packed(v, hkv, dh)
                write(pools.k, kq, li)
                write(pools.v, vq, li)
                write(pools.scales, pa.combine_scales(k_scale, v_scale, hkv), li)
            else:
                write(pools.k, pa.pack_heads(k, hkv, dh), li)
                write(pools.v, pa.pack_heads(v, hkv, dh), li)
        return self.norm(x), pools

    def decode_paged(self, x: torch.Tensor, pools: pa.PagedPools,
                     index: Union[int, torch.Tensor],
                     active: Optional[torch.Tensor] = None, *, page_size: int,
                     pages_per_slot: int, tp_group=None
                     ) -> Tuple[torch.Tensor, pa.PagedPools]:
        """One-token decode step over paged pools.

        x: [B, D] input embeddings; index: the per-slot lengths BEFORE this
        token, int [B], or one int when every slot has the same length;
        active: bool [B] (optional) — an inactive slot attends over nothing
        (length 0) and its output is garbage the caller masks.  The paged
        kernel attends the cached history and appends the fresh row (rows at
        capacity are written to the last position; int8 pools get the row
        quantized per token and head outside the kernel, as
        ``quantize_packed``); an int ``index`` tells it the longest length,
        which picks the kernel (``ops.paged_allheads.paged_kernel``).  The
        fresh token's own term merges analytically in f32 and unquantized
        from the (o, m, l) stats — for a length-0 slot (m = -inf, l = 0)
        that is exactly the self attention.  Returns (hidden [B, D], pools)."""
        b, _ = x.shape
        cfg = self.cfg
        h, hkv, dh = cfg.num_heads, cfg.kv_heads, cfg.head_dim
        groups = h // hkv
        capacity = pages_per_slot * page_size
        max_length = None
        if isinstance(index, int):
            max_length = min(index, capacity)
            index = torch.full((b,), index, dtype=torch.int32, device=x.device)
        index = index.to(torch.int32)
        write_pos = index.clamp(0, capacity - 1)
        lengths = index.clamp(max=capacity)
        if active is not None:
            lengths = torch.where(active.bool(), lengths, 0).to(torch.int32)
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
            if pools.quantized:
                kq, k_scale = pa.quantize_packed(k, hkv, dh)
                vq, v_scale = pa.quantize_packed(v, hkv, dh)
                rows = (kq, vq, pa.combine_scales(k_scale, v_scale, hkv))
            else:
                rows = (pa.pack_heads(k, hkv, dh).contiguous(),
                        pa.pack_heads(v, hkv, dh).contiguous(), None)
            write = rows + (base_pages + write_pos // page_size, write_offs)
            o, m, l, pools = pa.paged_attention_stats(
                qs, pools, lengths, base_pages, write, page_size=page_size,
                pages_per_slot=pages_per_slot, kv_heads=hkv, head_dim=dh,
                max_length=max_length)

            k_rep = k.float().repeat_interleave(groups, dim=1)  # [B, H, Dh]
            v_rep = v.float().repeat_interleave(groups, dim=1)
            s_self = torch.sum(qs * k_rep, dim=-1)  # [B, H]
            m2 = torch.maximum(m, s_self)
            w_cache = l * torch.exp(m - m2)
            w_self = torch.exp(s_self - m2)
            attn = ((w_cache[..., None] * o + w_self[..., None] * v_rep)
                    / (w_cache + w_self)[..., None])
            x = layer.finish(x, attn.reshape(b, h * dh).to(x.dtype), tp_group)
        return self.norm(x), pools
