"""IBM Granite 4.0-H's hybrid decoder stack (Mamba-2 and attention layers)
as the MIDI model's event net.

The layers follow HF ``GraniteMoeHybridDecoderLayer`` (``transformers``
4.57, dense: the ``shared_mlp`` and no routed experts):

- ``x + mixer(norm(x)) * residual_multiplier``, the mixer a Mamba-2 block
  (``mamba``: ``in_proj`` -> z, xBC, dt; causal depthwise convolution and
  SiLU; the SSD recurrence, ``ops.ssm``; ``RMSNormGated(y, z)``;
  ``out_proj``) or attention without positions (``self_attn``: GQA, scores
  times ``attention_multiplier`` in place of ``head_dim**-0.5``), as
  ``layer_types`` says;
- ``x + shared_mlp(norm(x)) * residual_multiplier``, the MLP
  ``output_linear(silu(gate) * up)`` with gate, up the halves of
  ``input_linear``;
- the input embedding times ``embedding_multiplier``, a final norm.

Granite's causal-LM head (``logits_scaling``, tied embeddings) is not
here: the MIDI model puts its own token net and ``lm_head`` on the event
net's hidden states.  Parameter names are HF's (``layers.{i}.mamba.
in_proj.weight``, ``layers.{i}.self_attn.q_proj.weight``, ``layers.{i}.
shared_mlp.input_linear.weight``, ...).  The numerics of the Llama stack
hold: norms in f32, products in the weight dtype; the Mamba-2 state is f32.

Three ways through the stack, as :class:`models.llama.LlamaStack`'s:

- :meth:`HybridStack.forward`, cacheless (the causal attention kernel and
  the scan over whole rows);
- :meth:`HybridStack.prefill_paged`, a bucket of prompts of their own
  lengths: the attention layers' K/V into paged pools, and each prompt's
  final SSM and conv states installed into the prompt's slot;
- :meth:`HybridStack.decode_paged`, one row per slot: the streaming paged
  kernel on the attention layers, :func:`ops.ssm.ssm_step` on the Mamba-2
  layers.

The paged paths take and return the stack's per-slot storage
(:class:`HybridStorage`), as ``LlamaStack``'s take its pools.

Paged pools hold the attention layers only.  The paged kernels take at
most 16 query heads a slot, so a slot's kv heads are split over
:attr:`HybridStack.kv_split` virtual slots (32 query / 8 kv heads: two of
16 / 4), each with its own pages: virtual layer ``a * split + part`` of
attention layer ``a``, page ``(virtual layer * slots + slot) *
pages_per_slot``.

On the card, :class:`GraphedDecode` replays :meth:`HybridStack.
decode_paged` as one CUDA graph: a step of 40 layers is some 450 small
kernels, which the host would otherwise launch one by one at every event.

Training, LoRA, int8 pools, meshes and the fused decode kernels do not
take a hybrid net; each raises where it is asked for.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import paged_allheads as pa
from ..ops import ssm
from ..ops.attention import causal_attention
from ..ops.hybrid_norm import add_rms_norm, swiglu
from ..utils import profiling
from .config import HybridConfig
from .llama import Attention, RMSNorm, _linear, resolve_device


class SlotState(NamedTuple):
    """Per-slot state of the Mamba-2 layers: ``ssm [layers, slots, H, P,
    N]`` f32 and ``conv [layers, slots, K - 1, conv_dim]`` in the model
    dtype (the last K - 1 pre-convolution rows), layer ``m`` the m-th Mamba-2
    layer."""

    ssm: torch.Tensor
    conv: torch.Tensor

    def nbytes(self) -> int:
        """Bytes of every slot's state."""
        return self.ssm.element_size() * self.ssm.numel() + (
            self.conv.element_size() * self.conv.numel())


class HybridStorage(NamedTuple):
    """A hybrid net's per-slot storage: the attention layers' pools, the
    Mamba-2 layers' states, on the card the decode step captured over both."""

    pools: pa.PagedPools
    state: SlotState
    graph: Optional["GraphedDecode"] = None


class MambaMixer(nn.Module):
    def __init__(self, cfg: HybridConfig, dtype, device):
        super().__init__()
        d, inner, h = cfg.hidden_size, cfg.mamba_intermediate, cfg.mamba_n_heads
        cd, k = cfg.conv_dim, cfg.mamba_d_conv
        self.cfg = cfg
        self.in_proj = _linear(d, inner + cd + h, dtype, device)
        self.conv1d = nn.utils.skip_init(nn.Conv1d, cd, cd, k, groups=cd, padding=k - 1,
                                         bias=True, dtype=dtype, device=device)
        self.dt_bias = nn.Parameter(torch.empty(h, dtype=dtype, device=device))
        self.A_log = nn.Parameter(torch.empty(h, dtype=dtype, device=device))
        self.D = nn.Parameter(torch.empty(h, dtype=dtype, device=device))
        self.norm = RMSNorm(inner, cfg.rms_norm_eps, dtype, device)
        self.out_proj = _linear(inner, d, dtype, device)

    def prefill(self, h: torch.Tensor, lengths: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """``h [G, S, D]`` (normed) of prompts of ``lengths`` rows -> (the
        mixer's output [G, S, D], each prompt's SSM state [G, H, P, N] f32
        and conv state [G, K - 1, conv_dim] after its last row)."""
        cfg = self.cfg
        g_n, s, _ = h.shape
        heads, p, n, groups = (cfg.mamba_n_heads, cfg.mamba_d_head, cfg.mamba_d_state,
                               cfg.mamba_n_groups)
        inner = cfg.mamba_intermediate
        z, xbc, dt = ssm.split_projection(self.in_proj(h), inner, cfg.conv_dim)
        xbc, conv_state = ssm.causal_conv(xbc, self.conv1d.weight, self.conv1d.bias, lengths)
        x = xbc[..., :inner].view(g_n, s, heads, p)
        b = xbc[..., inner:inner + groups * n].view(g_n, s, groups, n)
        c = xbc[..., inner + groups * n:].view(g_n, s, groups, n)
        dt = F.softplus(dt.float() + self.dt_bias.float())
        y, state = ssm.ssm_scan(x, b, c, dt.contiguous(), -torch.exp(self.A_log.float()),
                                self.D.float(), lengths.to(torch.int32),
                                chunk=cfg.mamba_chunk_size)
        out = ssm.gated_rms_norm(y.view(g_n, s, inner), z, self.norm.weight, cfg.rms_norm_eps)
        return self.out_proj(out), state, conv_state

    def step(self, h: torch.Tensor, ssm_state: torch.Tensor, conv_state: torch.Tensor
             ) -> torch.Tensor:
        """One row per slot, ``h [B, D]`` (normed); the states advance in
        place.  Returns the mixer's output [B, D]."""
        cfg = self.cfg
        out = ssm.ssm_step(self.in_proj(h), conv_state, ssm_state, self.conv1d.weight,
                           self.conv1d.bias, self.dt_bias, self.A_log, self.D,
                           self.norm.weight, cfg.rms_norm_eps, groups=cfg.mamba_n_groups)
        return self.out_proj(out)


class SharedMLP(nn.Module):
    def __init__(self, cfg: HybridConfig, dtype, device):
        super().__init__()
        d, f = cfg.hidden_size, cfg.intermediate_size
        self.input_linear = _linear(d, 2 * f, dtype, device)
        self.output_linear = _linear(f, d, dtype, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        gate, up = self.input_linear(x).chunk(2, dim=-1)
        return self.output_linear(F.silu(gate) * up)


class HybridLayer(nn.Module):
    def __init__(self, cfg: HybridConfig, kind: str, dtype, device):
        super().__init__()
        self.cfg = cfg
        self.kind = kind
        self.input_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, dtype, device)
        self.post_attention_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, dtype,
                                                device)
        self.shared_mlp = SharedMLP(cfg, dtype, device)
        if kind == "mamba":
            self.mamba = MambaMixer(cfg, dtype, device)
        else:
            self.self_attn = Attention(cfg, dtype, device)

    def qkv(self, h: torch.Tensor):
        """h [B, S, D] (normed) -> q [B, S, H, Dh], k, v [B, S, Hkv, Dh] (no
        positions: NoPE)."""
        b, s, _ = h.shape
        cfg, at = self.cfg, self.self_attn
        return (at.q_proj(h).view(b, s, cfg.num_heads, cfg.head_dim),
                at.k_proj(h).view(b, s, cfg.kv_heads, cfg.head_dim),
                at.v_proj(h).view(b, s, cfg.kv_heads, cfg.head_dim))

    def finish(self, x: torch.Tensor, mixed: torch.Tensor) -> torch.Tensor:
        """The mixer's residual add, then the MLP's."""
        rm = self.cfg.residual_multiplier
        x = x + mixed * rm
        return x + self.shared_mlp(self.post_attention_layernorm(x)) * rm


class HybridStack(nn.Module):
    def __init__(self, cfg: HybridConfig, dtype=torch.float32, device=None):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        self.embed_tokens = nn.utils.skip_init(nn.Embedding, cfg.vocab_size, cfg.hidden_size,
                                               dtype=dtype, device=device)
        self.layers = nn.ModuleList(HybridLayer(cfg, kind, dtype, device)
                                    for kind in cfg.layer_types)
        self.norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, dtype, device)
        # kv heads a virtual slot of the pools holds (kv_split of them a slot)
        self.kv_split = next(s for s in range(1, cfg.kv_heads + 1)
                             if cfg.kv_heads % s == 0 and cfg.num_heads // s <= pa.MAX_HEADS)

    # ---- per-slot storage ------------------------------------------------

    def pool_geometry(self) -> Tuple[int, int]:
        """(virtual layers, kv heads each) of the paged pools."""
        return len(self.cfg.attention_layers) * self.kv_split, self.cfg.kv_heads // self.kv_split

    def alloc_storage(self, slots: int, pages_per_slot: int, page_size: int,
                      kv_int8: bool = False) -> HybridStorage:
        """Zeroed storage for ``slots`` slots (no int8 pools); on the card
        the step is captured over it before any prompt is admitted."""
        if kv_int8:
            raise ValueError("a hybrid event net keeps its pools in the model dtype: no kv_int8")
        cfg, weight = self.cfg, self.norm.weight
        layers, kv = self.pool_geometry()
        pools = pa.alloc_pools(kv, layers * slots * pages_per_slot, page_size, cfg.head_dim,
                               weight.dtype, weight.device)
        m = len(cfg.mamba_layers)
        state = SlotState(
            torch.zeros((m, slots, cfg.mamba_n_heads, cfg.mamba_d_head, cfg.mamba_d_state),
                        dtype=torch.float32, device=weight.device),
            torch.zeros((m, slots, cfg.mamba_d_conv - 1, cfg.conv_dim),
                        dtype=weight.dtype, device=weight.device))
        storage = HybridStorage(pools, state)
        if weight.device.type == "cuda":
            storage = storage._replace(graph=GraphedDecode(
                self, storage, slots, page_size=page_size, pages_per_slot=pages_per_slot))
        return storage

    # ---- the three paths -------------------------------------------------

    def forward(self, emb: torch.Tensor, cache=None, remat: Union[bool, str] = False,
                tp_group=None) -> Tuple[torch.Tensor, None]:
        """``emb [B, S, D]`` -> (hidden after the final norm, None): every
        row of every sequence, causal, from empty states."""
        if cache is not None or remat or tp_group is not None:
            raise ValueError("a hybrid event net runs its cacheless forward without remat or "
                             "a model axis (the paged paths serve it)")
        b, s, _ = emb.shape
        lengths = torch.full((b,), s, dtype=torch.int32, device=emb.device)
        x = emb * self.cfg.embedding_multiplier
        for layer in self.layers:
            x = self._layer_prefill(layer, x, lengths)[0]
        return self.norm(x), None

    def _layer_prefill(self, layer: HybridLayer, x: torch.Tensor, lengths: torch.Tensor):
        """(x after the layer, its K and V or its SSM and conv states)."""
        b, s, _ = x.shape
        h = layer.input_layernorm(x)
        if layer.kind == "mamba":
            mixed, *states = layer.mamba.prefill(h, lengths)
        else:
            q, k, v = layer.qkv(h)
            attn = causal_attention(q, k, v, scale=self.cfg.attention_multiplier)
            mixed, states = layer.self_attn.o_proj(attn.reshape(b, s, -1)), (k, v)
        return layer.finish(x, mixed), states

    def prefill_paged(self, emb: torch.Tensor, storage: HybridStorage, *, page_size: int,
                      pages_per_slot: int, slots: Optional[torch.Tensor] = None,
                      n_slots: Optional[int] = None, lengths=None, tp_group=None
                      ) -> Tuple[torch.Tensor, HybridStorage]:
        """Prompts ``emb [G, S, D]`` of ``lengths`` rows (int [G], all S by
        default), rows past a prompt's length padding: each attention
        layer's K/V go to the prompt's slot's pages (whole pages, as
        ``LlamaStack.prefill_paged``), and its states after its last row
        into its slot (span ``batcher.state_install``: the enclosing span's
        ``rids``, ``bytes``).  Counters ``batcher.ssm_scan_rows`` and
        ``_pad_rows``: the scan's whole chunks up to each prompt's length
        within the bucket, and their pad rows (host ``lengths`` spare a
        wait for the device).  Returns (hidden [G, S, D], storage)."""
        if tp_group is not None:
            raise ValueError("a hybrid event net takes no model axis")
        g_n, s, _ = emb.shape
        cfg = self.cfg
        if slots is None:
            slots = torch.arange(g_n, device=emb.device)
            n_slots = g_n
        lengths = torch.as_tensor([s] * g_n if lengths is None else lengths, dtype=torch.int32)
        if profiling.on():  # whole chunks up to each prompt's length, within the bucket
            host = lengths.tolist()
            ran = sum(min(-(-n // cfg.mamba_chunk_size) * cfg.mamba_chunk_size, s) for n in host)
            profiling.count("batcher.ssm_scan_rows", ran)
            profiling.count("batcher.ssm_scan_pad_rows", ran - sum(host))
        lengths = lengths.to(emb.device, non_blocking=True)
        pools = storage.pools
        layers, kv = self.pool_geometry()
        if pools.k.shape[0] != layers * n_slots * pages_per_slot:
            raise ValueError(f"pools hold {pools.k.shape[0]} pages, expected "
                             f"{layers * n_slots * pages_per_slot}")
        ps = page_size
        n_pre = min(-(-s // ps), pages_per_slot)
        rows = n_pre * ps
        page = (slots.long()[:, None] * pages_per_slot
                + torch.arange(n_pre, device=emb.device)[None, :])  # [G, n_pre]

        def write(buf, flat, vl):  # flat [G, S, w] -> virtual layer vl's pages
            flat = F.pad(flat, (0, 0, 0, max(rows - s, 0)))[:, :rows]
            buf[vl * n_slots * pages_per_slot + page] = flat.reshape(
                g_n, n_pre, ps, flat.shape[-1]).to(buf.dtype)

        x = emb * cfg.embedding_multiplier
        ai = 0
        ssm_states, conv_states = [], []
        for layer in self.layers:
            x, states = self._layer_prefill(layer, x, lengths)
            if layer.kind == "mamba":
                ssm_states.append(states[0])
                conv_states.append(states[1])
                continue
            k, v = states
            for part in range(self.kv_split):
                heads = slice(part * kv, (part + 1) * kv)
                vl = ai * self.kv_split + part
                write(pools.k, pa.pack_heads(k[:, :, heads], kv, cfg.head_dim), vl)
                write(pools.v, pa.pack_heads(v[:, :, heads], kv, cfg.head_dim), vl)
            ai += 1
        hidden = self.norm(x)
        group = SlotState(torch.stack(ssm_states), torch.stack(conv_states))
        with profiling.span("batcher.state_install", inherit=("rids",)) as sp:
            if sp:
                sp.attrs["bytes"] = group.nbytes()
            storage.state.ssm[:, slots] = group.ssm
            storage.state.conv[:, slots] = group.conv
        return hidden, storage

    def decode_paged(self, x: torch.Tensor, storage: HybridStorage,
                     index: Union[int, torch.Tensor], active: Optional[torch.Tensor] = None,
                     *, page_size: int, pages_per_slot: int, tp_group=None
                     ) -> Tuple[torch.Tensor, HybridStorage]:
        """One row per slot, ``x [B, D]`` (input embeddings), ``index`` each
        slot's rows before it (int [B] or one int), ``active`` bool [B]: an
        inactive slot attends over nothing and its output is garbage the
        caller masks.  The attention layers attend their paged K/V and append
        the row (``LlamaStack.decode_paged``'s merge of the row's own term,
        q pre-scaled by ``attention_multiplier``); the Mamba-2 layers advance
        every slot's state in place.  Each residual add runs fused with the
        norm after it, and the MLP's SwiGLU in one launch
        (``ops.hybrid_norm``).  A captured step replays (index and active
        tensors; its hidden is overwritten by the next call).  Returns
        (hidden [B, D], storage)."""
        if tp_group is not None:
            raise ValueError("a hybrid event net takes no model axis")
        if storage.graph is not None:
            return storage.graph(x, index, active), storage
        pools, state = storage.pools, storage.state
        b, _ = x.shape
        cfg = self.cfg
        capacity = pages_per_slot * page_size
        max_length = None
        if isinstance(index, int):
            max_length = min(index, capacity)
            index = torch.full((b,), index, dtype=torch.int32, device=x.device)
        index = index.to(torch.int32)
        lengths = index.clamp(max=capacity)
        if active is not None:
            lengths = torch.where(active.bool(), lengths, 0).to(torch.int32)
        paged = dict(write_pos=index.clamp(0, capacity - 1), lengths=lengths,
                     max_length=max_length, page_size=page_size, pages_per_slot=pages_per_slot)

        eps, rm = cfg.rms_norm_eps, cfg.residual_multiplier
        norms = [layer.input_layernorm.weight for layer in self.layers[1:]] + [self.norm.weight]
        x, hn = add_rms_norm(x * cfg.embedding_multiplier, None,
                             self.layers[0].input_layernorm.weight, eps)
        mi = ai = 0
        for layer, next_norm in zip(self.layers, norms):
            if layer.kind == "mamba":
                mixed = layer.mamba.step(hn, state.ssm[mi], state.conv[mi])
                mi += 1
            else:
                mixed = self._attend(layer, ai, hn, pools, **paged)
                ai += 1
            x, h = add_rms_norm(x, mixed, layer.post_attention_layernorm.weight, eps, rm)
            mlp = layer.shared_mlp
            x, hn = add_rms_norm(x, mlp.output_linear(swiglu(mlp.input_linear(h))), next_norm,
                                 eps, rm)
        return hn, storage

    def _attend(self, layer: HybridLayer, ai: int, hn: torch.Tensor, pools: pa.PagedPools, *,
                write_pos: torch.Tensor, lengths: torch.Tensor, max_length: Optional[int],
                page_size: int, pages_per_slot: int) -> torch.Tensor:
        """Attention layer ``ai`` for one row per slot (``hn`` normed): the
        paged kernel over each slot's cached rows, appending this row, merged
        with the row's own term in f32; then ``o_proj``."""
        b = hn.shape[0]
        cfg = self.cfg
        h, hkv, dh = cfg.num_heads, cfg.kv_heads, cfg.head_dim
        split = self.kv_split
        kvs, groups = hkv // split, h // hkv

        def parts(t, n_heads):  # [B, n, Dh] -> [split * B, n / split, Dh], part-major
            return t.reshape(b, split, n_heads // split, dh).transpose(0, 1).reshape(
                split * b, n_heads // split, dh)

        def whole(t):  # [split * B, ...] -> [B, split * ...], heads in order
            return t.reshape(split, b, *t.shape[1:]).transpose(0, 1).reshape(b, -1)

        q, k, v = (t[:, 0] for t in layer.qkv(hn[:, None, :]))
        qs = q.float() * cfg.attention_multiplier  # the kernel does no scaling
        virtual = torch.arange(split * b, dtype=torch.int32, device=hn.device)
        base = (ai * split * b + virtual) * pages_per_slot
        write = (pa.pack_heads(parts(k, hkv), kvs, dh).contiguous(),
                 pa.pack_heads(parts(v, hkv), kvs, dh).contiguous(), None,
                 base + (write_pos // page_size).repeat(split),
                 (write_pos % page_size).repeat(split))
        o, m, l, _ = pa.paged_attention_stats(
            parts(qs, h).contiguous(), pools, lengths.repeat(split), base, write,
            page_size=page_size, pages_per_slot=pages_per_slot, kv_heads=kvs, head_dim=dh,
            max_length=max_length)
        o, m, l = whole(o).view(b, h, dh), whole(m), whole(l)
        k_rep = k.float().repeat_interleave(groups, dim=1)  # [B, H, Dh]
        v_rep = v.float().repeat_interleave(groups, dim=1)
        s_self = torch.sum(qs * k_rep, dim=-1)  # [B, H]
        m2 = torch.maximum(m, s_self)
        w_cache = l * torch.exp(m - m2)
        w_self = torch.exp(s_self - m2)
        attn = ((w_cache[..., None] * o + w_self[..., None] * v_rep)
                / (w_cache + w_self)[..., None])
        return layer.self_attn.o_proj(attn.reshape(b, h * dh).to(hn.dtype))


class GraphedDecode:
    """:meth:`HybridStack.decode_paged` over a fixed storage for a fixed
    batch, captured once as a CUDA graph and replayed: a call copies its
    inputs into the graph's own and returns the graph's output tensor,
    which the next call overwrites.  Capturing runs the step on its inputs
    twice first (zeros, every slot inactive): that appends a row at position
    0 of every slot's pages and advances every slot's state, so
    :meth:`HybridStack.alloc_storage` captures before any admission."""

    def __init__(self, net: HybridStack, storage: HybridStorage, batch: int, *,
                 page_size: int, pages_per_slot: int):
        weight = net.norm.weight
        self.x = torch.zeros((batch, net.cfg.hidden_size), dtype=weight.dtype,
                             device=weight.device)
        self.index = torch.zeros((batch,), dtype=torch.int32, device=weight.device)
        self.active = torch.zeros((batch,), dtype=torch.bool, device=weight.device)

        def step():  # (the storage holds no graph yet)
            return net.decode_paged(self.x, storage, self.index, self.active,
                                    page_size=page_size, pages_per_slot=pages_per_slot)[0]

        side = torch.cuda.Stream(weight.device)
        side.wait_stream(torch.cuda.current_stream(weight.device))
        with torch.no_grad():
            with torch.cuda.stream(side):  # first calls allocate the kernels' scratch
                for _ in range(2):
                    step()
            torch.cuda.current_stream(weight.device).wait_stream(side)
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.graph):
                self.out = step()

    def __call__(self, x: torch.Tensor, index: torch.Tensor, active: torch.Tensor
                 ) -> torch.Tensor:
        self.x.copy_(x)
        self.index.copy_(index)
        self.active.copy_(active)
        self.graph.replay()
        return self.out
