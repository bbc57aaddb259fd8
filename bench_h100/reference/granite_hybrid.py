"""The architecture module of SkyTNT's MIDI model with IBM Granite 4.0-H's
hybrid decoder as its event net, in plain float32 PyTorch: its state-dict
layout with init rules, the reference model and the counts of its work
(what ``bench_h100/README.md`` asks of an architecture module).

The event net follows HF ``GraniteMoeHybridModel`` (``transformers`` 4.57,
``modeling_granitemoehybrid.py``, dense): the input embedding times
``embedding_multiplier``; per layer ``x + mixer(rms(x)) * residual_
multiplier`` then ``x + shared_mlp(rms(x)) * residual_multiplier``, the
MLP ``output_linear(silu(gate) * up)`` with gate, up the halves of
``input_linear``; a final norm.  The mixer is, by ``layer_types``:

- attention: GQA without positions (``position_embedding_type`` nope),
  causal softmax of scores times ``attention_multiplier``;
- Mamba-2 (``torch_forward``): ``in_proj`` -> z, xBC, dt; a causal
  depthwise convolution of width ``mamba_d_conv`` with bias, then SiLU;
  x, B, C from xBC (head h reads group h // (H / G)); dt = softplus(dt +
  dt_bias), A = -exp(A_log); then ``y_i = sum_{j <= i} (C_i . B_j)
  exp(sum_{j < t <= i} dt_t A) dt_j x_j + D x_i``, the recurrence
  ``h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t^T, y_t = C_t h_t + D x_t``
  unrolled; ``RMSNormGated``: ``w * rms(y * silu(z))``; ``out_proj``.

The token net and ``lm_head`` are the Llama family's (``model.py``):
granite's causal-LM head (``logits_scaling``, tied embeddings) is not part
of the MIDI model.  The judge runs this module under
``precision.full_f32`` (TF32 off); ``precision="fp8"`` rounds every linear
layer's input and weight, as ``model.py`` does.

Departures from ``torch_forward`` (none changes the function):

- the SSM is computed in its quadratic (masked-decay) form, in blocks of
  query rows, and not by HF's chunked algorithm (nor the program's);
- the decay's cumulative sums over the rows are taken in float64, so that
  a difference of two long sums keeps its digits (in f32 a sum of ~1,500
  steps of -dt A loses about 1e-4 absolutely);
- the convolution is written as K shifted products (the same sum).

Counts (floors, from shapes; a multiply-add is 2 operations): a layer's
products are its projections; attention over ``c`` keys costs ``4 * heads
* head_dim * c`` a query in the 4 attention layers; a Mamba-2 layer's step
``4 * H * P * N`` (the state's multiply-adds: decay and input, then C) and
``2 * K * conv_dim`` (the convolution); its scan is counted by
:func:`ssm_scan_flops` at the published chunk of 256 rows, whatever the
program does.  The cache a slot's event step reads and appends is the
attention layers' K/V rows plus the fixed per-slot state: the SSM state in
f32 and the conv state in the model dtype, each read and written once.
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch
import torch.nn.functional as F

from . import model as llama
from .precision import fp8_round

QUERY_BLOCK = 256  # query rows per block of the attention and the quadratic SSM
CONV_INIT = 0.5  # PyTorch's Conv1d default bound at fan-in 4: 1 / sqrt(4)


def _kinds(c: dict) -> List[str]:
    return list(c["layer_types"])


class HybridNet:
    """The granite hybrid stack over given input embeddings."""

    def __init__(self, prefix: str, cfg: dict, w: Dict[str, torch.Tensor], precision: str):
        self.prefix, self.w, self.precision = prefix, w, precision
        self.kinds = _kinds(cfg)
        self.hidden = cfg["hidden_size"]
        self.heads = cfg["num_attention_heads"]
        self.kv_heads = cfg.get("num_key_value_heads") or self.heads
        self.head_dim = self.hidden // self.heads
        self.eps = cfg["rms_norm_eps"]
        self.emb_mult = cfg["embedding_multiplier"]
        self.res_mult = cfg["residual_multiplier"]
        self.attn_mult = cfg["attention_multiplier"]
        self.m_heads = cfg["mamba_n_heads"]
        self.m_head_dim = cfg["mamba_d_head"]
        self.d_state = cfg["mamba_d_state"]
        self.groups = cfg["mamba_n_groups"]
        self.d_conv = cfg["mamba_d_conv"]
        self.inner = cfg["mamba_expand"] * self.hidden

    def p(self, name: str) -> torch.Tensor:
        return self.w[f"{self.prefix}.{name}"]

    def linear(self, x: torch.Tensor, name: str) -> torch.Tensor:
        w = self.p(name)
        if self.precision == "fp8":
            x, w = fp8_round(x), fp8_round(w)
        return x @ w.t()

    def norm(self, x: torch.Tensor, name: str) -> torch.Tensor:
        return self.p(name) * (x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + self.eps))

    def attention(self, h: torch.Tensor, pre: str) -> torch.Tensor:
        b, s, _ = h.shape
        q = self.linear(h, pre + "q_proj.weight").view(b, s, self.heads, -1).transpose(1, 2)
        k = self.linear(h, pre + "k_proj.weight").view(b, s, self.kv_heads, -1).transpose(1, 2)
        v = self.linear(h, pre + "v_proj.weight").view(b, s, self.kv_heads, -1).transpose(1, 2)
        rep = self.heads // self.kv_heads
        k, v = k.repeat_interleave(rep, dim=1), v.repeat_interleave(rep, dim=1)
        outs = []
        for at in range(0, s, QUERY_BLOCK):
            qb = q[:, :, at:at + QUERY_BLOCK]
            rows = torch.arange(at, at + qb.shape[2], device=h.device)
            cols = torch.arange(s, device=h.device)
            scores = (qb @ k.transpose(-1, -2)) * self.attn_mult
            scores = scores.masked_fill(cols[None, :] > rows[:, None], float("-inf"))
            outs.append(torch.softmax(scores, dim=-1) @ v)
        attn = torch.cat(outs, dim=2).transpose(1, 2).reshape(b, s, -1)
        return self.linear(attn, pre + "o_proj.weight")

    def mamba(self, h: torch.Tensor, pre: str) -> torch.Tensor:
        b, s, _ = h.shape
        hh, pp, n, g, k = self.m_heads, self.m_head_dim, self.d_state, self.groups, self.d_conv
        inner = self.inner
        proj = self.linear(h, pre + "in_proj.weight")
        conv_dim = inner + 2 * g * n
        z, xbc, dt = proj.split([inner, conv_dim, hh], dim=-1)
        conv_w = self.p(pre + "conv1d.weight")[:, 0]  # [C, K]
        padded = F.pad(xbc, (0, 0, k - 1, 0))
        conv = self.p(pre + "conv1d.bias").expand_as(xbc)
        for j in range(k):
            conv = conv + padded[:, j:j + s] * conv_w[:, j]
        xbc = F.silu(conv)
        x = xbc[..., :inner].reshape(b, s, hh, pp)
        bm = xbc[..., inner:inner + g * n].reshape(b, s, g, n)
        cm = xbc[..., inner + g * n:].reshape(b, s, g, n)
        dt = F.softplus(dt + self.p(pre + "dt_bias"))  # [b, s, H]
        a = -torch.exp(self.p(pre + "A_log"))
        y = ssd_quadratic(x, bm, cm, dt, a, self.p(pre + "D"))
        y = y.reshape(b, s, inner) * F.silu(z)
        y = self.p(pre + "norm.weight") * (y * torch.rsqrt(y.pow(2).mean(-1, keepdim=True)
                                                           + self.eps))
        return self.linear(y, pre + "out_proj.weight")

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        """x [B, S, D] input embeddings -> hidden states after the final norm."""
        x = x * self.emb_mult
        for i, kind in enumerate(self.kinds):
            pre = f"layers.{i}."
            h = self.norm(x, pre + "input_layernorm.weight")
            mixed = (self.mamba(h, pre + "mamba.") if kind == "mamba"
                     else self.attention(h, pre + "self_attn."))
            x = x + mixed * self.res_mult
            h = self.norm(x, pre + "post_attention_layernorm.weight")
            up = self.linear(h, pre + "shared_mlp.input_linear.weight")
            gate, up = up.chunk(2, dim=-1)
            x = x + self.linear(F.silu(gate) * up, pre + "shared_mlp.output_linear.weight") \
                * self.res_mult
        return self.norm(x, "norm.weight")


def ssd_quadratic(x: torch.Tensor, bm: torch.Tensor, cm: torch.Tensor, dt: torch.Tensor,
                  a: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """The SSM of every row from a zero state, in its quadratic (masked-decay)
    form: x [b, s, H, P], bm, cm [b, s, G, N], dt [b, s, H] (after
    softplus), a, d [H] -> y [b, s, H, P], in blocks of query rows."""
    b, s, hh, _ = x.shape
    g = bm.shape[2]
    cum = torch.cumsum((dt * a).double(), dim=1)  # [b, s, H]
    head_group = torch.arange(hh, device=x.device) // (hh // g)
    ys = []
    for at in range(0, s, QUERY_BLOCK):
        end = min(at + QUERY_BLOCK, s)
        scores = torch.einsum("bign,bjgn->bgij", cm[:, at:end], bm[:, :end])
        scores = scores[:, head_group]  # [b, H, i, j]
        seg = cum[:, at:end, None, :] - cum[:, None, :end, :]  # [b, i, j, H]
        rows = torch.arange(at, end, device=x.device)[:, None]
        causal = torch.arange(end, device=x.device)[None, :] <= rows
        decay = torch.where(causal[None, :, :, None], torch.exp(seg.clamp(max=0.0)), 0.0)
        weights = (scores * decay.float().permute(0, 3, 1, 2)
                   * dt[:, :end].permute(0, 2, 1)[:, :, None, :])
        ys.append(torch.einsum("bhij,bjhp->bihp", weights, x[:, :end]))
    return torch.cat(ys, dim=1) + d[:, None] * x


class MidiModel(llama.MidiModel):
    """The whole model (``net.*`` the hybrid event net, ``net_token.*`` and
    ``lm_head.weight`` the Llama family's) over float32 copies of the state
    dict."""

    def __init__(self, config: dict, state: Dict[str, torch.Tensor], precision: str = "f32"):
        super().__init__(config, state, precision)
        self.net = HybridNet("net", config["net_config"], self.w, precision)


def sequential_ssm(x, b, c, dt, a, d):
    """The Mamba-2 recurrence one row at a time (for the tests): x [S, H, P],
    b, c [S, H, N] (per head), dt [S, H], a, d [H] -> y [S, H, P]."""
    state = torch.zeros(x.shape[1], x.shape[2], b.shape[2], dtype=x.dtype)
    ys = []
    for t in range(x.shape[0]):
        state = (torch.exp(dt[t] * a)[:, None, None] * state
                 + (dt[t][:, None] * x[t])[..., None] * b[t][:, None, :])
        ys.append((state * c[t][:, None, :]).sum(-1) + d[:, None] * x[t])
    return torch.stack(ys)


# ---- the state-dict layout, with init rules ---------------------------------

def layout(config: dict) -> List[tuple]:
    """(name, shape[, rule]) of every tensor of the state dict, in drawing
    order: the Llama family's order for the embeddings, the token net and
    the head, the event net's layers by HF's names.  Rules: matrices N(0,
    init_std) and norms 1 (the defaults); ``A_log`` uniform(0, ln 16)
    (mamba_ssm's ``A_init_range`` (1, 16)); ``dt_bias`` uniform(-6.91,
    -2.25), whose softplus spans mamba_ssm's dt range 0.001-0.1; ``D`` 1;
    the convolution's weight and bias uniform(+-0.5), PyTorch's ``Conv1d``
    default at fan-in 4."""
    c = config["net_config"]
    vocab = config["tokenizer"]["vocab_size"]
    d, h = c["hidden_size"], c["num_attention_heads"]
    hkv = c.get("num_key_value_heads") or h
    dh = d // h
    f = c["shared_intermediate_size"]
    hm, n, g, k = c["mamba_n_heads"], c["mamba_d_state"], c["mamba_n_groups"], c["mamba_d_conv"]
    inner = c["mamba_expand"] * d
    conv = inner + 2 * g * n
    out = [("net.embed_tokens.weight", (vocab, d))]
    for i, kind in enumerate(_kinds(c)):
        pre = f"net.layers.{i}."
        if kind == "mamba":
            m = pre + "mamba."
            out += [(m + "in_proj.weight", (inner + conv + hm, d)),
                    (m + "conv1d.weight", (conv, 1, k), ("uniform", -CONV_INIT, CONV_INIT)),
                    (m + "conv1d.bias", (conv,), ("uniform", -CONV_INIT, CONV_INIT)),
                    (m + "dt_bias", (hm,), ("uniform", -6.91, -2.25)),
                    (m + "A_log", (hm,), ("uniform", 0.0, math.log(16.0))),
                    (m + "D", (hm,), ("const", 1.0)),
                    (m + "norm.weight", (inner,)),
                    (m + "out_proj.weight", (d, inner))]
        else:
            a = pre + "self_attn."
            out += [(a + "q_proj.weight", (h * dh, d)), (a + "k_proj.weight", (hkv * dh, d)),
                    (a + "v_proj.weight", (hkv * dh, d)), (a + "o_proj.weight", (d, h * dh))]
        out += [(pre + "shared_mlp.input_linear.weight", (2 * f, d)),
                (pre + "shared_mlp.output_linear.weight", (d, f)),
                (pre + "input_layernorm.weight", (d,)),
                (pre + "post_attention_layernorm.weight", (d,))]
    out.append(("net.norm.weight", (d,)))
    token = [e for e in llama.layout(config) if e[0].startswith("net_token.")]
    return out + token + [("lm_head.weight", (vocab, d))]


# ---- the work counts, from shapes alone ----------------------------------------

class Dims:
    """The event net's shapes.  ``layers`` counts the layers that attend
    (what the attention readers bound); ``mamba_layers`` the rest."""

    def __init__(self, c: dict, vocab: int):
        kinds = _kinds(c)
        self.layers = kinds.count("attention")
        self.mamba_layers = kinds.count("mamba")
        self.hidden = c["hidden_size"]
        self.heads = c["num_attention_heads"]
        self.kv_heads = c.get("num_key_value_heads") or self.heads
        self.head_dim = self.hidden // self.heads
        self.inter = c["shared_intermediate_size"]
        self.vocab = vocab
        self.m_heads, self.m_head_dim = c["mamba_n_heads"], c["mamba_d_head"]
        self.d_state, self.groups, self.d_conv = (c["mamba_d_state"], c["mamba_n_groups"],
                                                  c["mamba_d_conv"])
        self.m_inner = c["mamba_expand"] * self.hidden
        self.conv_dim = self.m_inner + 2 * self.groups * self.d_state

    @property
    def mlp_params(self) -> int:
        return 3 * self.hidden * self.inter

    @property
    def attention_params(self) -> int:
        d, hd, kvd = self.hidden, self.heads * self.head_dim, self.kv_heads * self.head_dim
        return 2 * d * hd + 2 * d * kvd

    @property
    def mamba_params(self) -> int:
        """A Mamba-2 mixer's parameters: in_proj, the convolution, dt_bias,
        A_log, D, the gated norm, out_proj."""
        return (self.hidden * (self.m_inner + self.conv_dim + self.m_heads)
                + self.conv_dim * (self.d_conv + 1) + 3 * self.m_heads + self.m_inner
                + self.m_inner * self.hidden)

    @property
    def matmul_params(self) -> int:
        """The parameters of every layer's products (what an event step's
        GEMMs read), both mixer kinds."""
        return (self.layers * (self.attention_params + self.mlp_params)
                + self.mamba_layers * (self.hidden * (self.m_inner + self.conv_dim + self.m_heads)
                                       + self.m_inner * self.hidden + self.mlp_params))

    @property
    def layer_elements(self) -> int:
        """Every parameter of the layers (norms included)."""
        norms = 2 * self.hidden
        return (self.layers * (self.attention_params + self.mlp_params + norms)
                + self.mamba_layers * (self.mamba_params + self.mlp_params + norms))

    @property
    def kv_row_elems(self) -> int:
        """K and V elements of one cached row over the attention layers."""
        return 2 * self.layers * self.kv_heads * self.head_dim

    @property
    def state_elems(self) -> int:
        """One slot's SSM state over the Mamba-2 layers."""
        return self.mamba_layers * self.m_heads * self.m_head_dim * self.d_state

    @property
    def conv_elems(self) -> int:
        """One slot's conv state over the Mamba-2 layers."""
        return self.mamba_layers * (self.d_conv - 1) * self.conv_dim

    def attn_flops(self, queries: float, keys: float) -> float:
        return 4.0 * self.heads * self.head_dim * queries * keys * self.layers

    @property
    def mamba_step_flops(self) -> float:
        """One row through one Mamba-2 layer's recurrence and convolution."""
        return (4.0 * self.m_heads * self.m_head_dim * self.d_state
                + 2.0 * self.d_conv * self.conv_dim)


def dims(config: dict):
    """(event net :class:`Dims`, token net ``model.Dims``)."""
    v = config["tokenizer"]["vocab_size"]
    return Dims(config["net_config"], v), llama.Dims(config["net_token_config"], v)


token_row_flops = llama.token_row_flops


def event_step_flops(config: dict, context: int) -> float:
    """One slot's event step: its token row, then the event net's step for
    the new row: every layer's products, attention over ``context`` cached
    rows and itself, each Mamba-2 layer's recurrence."""
    ev, _ = dims(config)
    return (token_row_flops(config) + 2.0 * ev.matmul_params + ev.attn_flops(1, context + 1)
            + ev.mamba_layers * ev.mamba_step_flops)


CHUNK = 256  # the published mamba_chunk_size the scan's floor is counted at


def _chunks(rows: int):
    return [min(CHUNK, rows - at) for at in range(0, rows, CHUNK)]


def ssm_scan_flops(config: dict, rows: int) -> float:
    """The SSD scan of one prompt of ``rows`` rows over every Mamba-2 layer,
    in chunks of 256: per chunk of q rows the causal C B^T (``q (q + 1) / 2``
    pairs, 2N each, once a group), the weighted x (2P a pair and head), the
    chunk's state (2 N P a row and head) and, after the first chunk, the
    previous state read by each row (2 N P a row and head)."""
    ev, _ = dims(config)
    total = 0.0
    for i, q in enumerate(_chunks(rows)):
        pairs = q * (q + 1) / 2
        total += 2.0 * pairs * ev.d_state * ev.groups
        total += ev.m_heads * (2.0 * pairs * ev.m_head_dim
                               + 2.0 * q * ev.d_state * ev.m_head_dim * (2 if i else 1))
    return ev.mamba_layers * total


def ssm_scan_bytes(config: dict, rows: int) -> float:
    """Its bytes: x, B and C read once (model dtype, 2 bytes), dt read and y
    written (f32), the final state written (f32), over every Mamba-2 layer."""
    ev, _ = dims(config)
    per_row = (2 * (ev.m_inner + 2 * ev.groups * ev.d_state) + 4 * ev.m_heads
               + 4 * ev.m_inner)
    state = 4 * ev.m_heads * ev.m_head_dim * ev.d_state
    return float(ev.mamba_layers * (rows * per_row + state))


def ssm_step_bytes(config: dict, slots: int) -> float:
    """One state-update launch (one Mamba-2 layer, ``slots`` slots): each
    slot's SSM state (f32) and conv state (2 bytes) read and written, its
    in_proj row read and its gated output written (2 bytes); the layer's
    convolution, dt_bias, A_log, D and norm parameters read once."""
    ev, _ = dims(config)
    per_slot = (2 * 4 * ev.m_heads * ev.m_head_dim * ev.d_state
                + 2 * 2 * (ev.d_conv - 1) * ev.conv_dim
                + 2 * (ev.m_inner + ev.conv_dim + ev.m_heads) + 2 * ev.m_inner)
    params = 2 * (ev.conv_dim * (ev.d_conv + 1) + 3 * ev.m_heads + ev.m_inner)
    return float(slots * per_slot + params)


def prefill_flops(config: dict, rows: int) -> float:
    """The event net over a prompt of ``rows`` events (causal)."""
    ev, _ = dims(config)
    return (2.0 * ev.matmul_params * rows + ev.attn_flops(1, rows * (rows + 1) / 2)
            + ssm_scan_flops(config, rows))


def weight_bytes(config: dict, elem: int = 2) -> float:
    """The weights an event step reads once: the event net's layers, the
    token net's, the head."""
    ev, tok = dims(config)
    return elem * (ev.layer_elements + tok.layer_params * tok.layers + tok.hidden * tok.vocab)


def cache_bytes(config: dict, context: int, pool: str) -> int:
    """The bytes of one slot's cache that one event step reads and appends:
    the attention layers' K/V of its ``context`` cached rows read and the
    new row's written and read back (two rows more) at the pool's element
    width (bf16 or f32: the hybrid takes no int8 pools), plus its fixed
    state, read and written: the SSM state in f32, the conv state in the
    model dtype."""
    ev, _ = dims(config)
    kv = llama.POOL_ELEM_BYTES[pool] * ev.kv_row_elems * (context + 2)
    model_elem = llama.POOL_ELEM_BYTES[config.get("dtype", "bfloat16")]
    return kv + 2 * (4 * ev.state_elems + model_elem * ev.conv_elems)


def train_forward_flops(config: dict, batch) -> float:
    """The forward's operations for a training batch (counted as the Llama
    family counts it, from this module's prefill and token row)."""
    import numpy as np

    pad = config["tokenizer"]["pad_id"]
    rows = np.asarray(batch).reshape(-1, *np.asarray(batch).shape[-2:])
    total = 0.0
    for r in rows:
        n_in = int((r[:-1, 0] != pad).sum())
        n_out = int((r[1:, 0] != pad).sum())
        total += prefill_flops(config, n_in) + n_out * token_row_flops(config)
    return total
