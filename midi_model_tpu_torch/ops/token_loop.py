"""The token row of one event — every step of the token net, the shared
``lm_head``, the grammar masks and the sampler — in one launch.

Counterpart of ``midi_model_tpu/ops/token_loop.py``.  The CUDA kernel is
``csrc/token_loop.cu``; :func:`decode_token_row_reference` is its plain
PyTorch version.  Semantics (the TPU kernel's, ``token_loop.py:107-262``):

- per-row ``temp``, ``top_p`` and ``top_k``;
- step 0 draws under the ``first`` mask; step ``j`` under ``steps[e_off, j]``
  with ``e_off = clip(tok0 - first_event_id, 0, E-1)``;
- a row that emitted eos at step 0 is ``pad_only`` from step 1 on; a
  ``forced_pad`` row is ``pad_only`` at every step, step 0 included;
- the optional ``allow`` plane [B, V] multiplies every step;
- greedy takes the first maximum; otherwise the top-p / top-k Gumbel draw
  of ``ops.sampler`` with step ``j``'s noise rows ``gumbel[j*B:(j+1)*B]``
  (the step-major ``[T*B, K_CAP]`` layout of ``sampling.gumbel_rows``);
- the next step's input is the token net's own ``embed_tokens`` row.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ..models.llama import DenseCache, rope_cos_sin
from . import _build
from .sampler import per_row, sample_top_p_k_reference

MAX_LAYERS = 8  # csrc/token_row.cuh kTokMaxLayers
# ids the sample phase takes: work[V], the draw's scratch (17,440 bytes,
# csrc/sampler.cuh SampleScratch) and the mask and allow rows' bytes in the
# 64 KB staged segment (token_row.cuh sample_scratch_fits)
SAMPLE_SCRATCH_BYTES = 17440


def sample_smem(vocab: int) -> int:
    """Shared memory of the token row's sample phase at ``vocab`` ids."""
    return -(-vocab // 4) * 16 + SAMPLE_SCRATCH_BYTES + 2 * (-(-(vocab + 8) // 16) * 16)


MAX_VOCAB = max(v for v in range(4, 16385, 4) if sample_smem(v) <= 64 * 1024)


def decode_token_row_reference(model, config, hidden: torch.Tensor, masks, temp,
                               top_p, top_k, gumbel: Optional[torch.Tensor], *,
                               greedy: bool,
                               forced_pad: Optional[torch.Tensor] = None,
                               allow: Optional[torch.Tensor] = None,
                               sample: Callable = sample_top_p_k_reference):
    """The plain version of :func:`decode_token_row`: the token net one step
    at a time through the model's modules, each draw through
    ``sample(probs, top_p, top_k, noise)`` (the plain sampler by default;
    the split decode path passes the sampler kernel's dispatcher)."""
    first, steps, pad_only = masks
    tokenizer = config.tokenizer
    b = hidden.shape[0]
    device = hidden.device
    t_max = tokenizer.max_token_seq
    eos_id = tokenizer.eos_id
    first_event_id = eos_id + 1
    n_events = steps.shape[0]
    temp_b = per_row(temp, b, torch.float32, device)[:, None]
    top_p = per_row(top_p, b, torch.float32, device)
    top_k = per_row(top_k, b, torch.int32, device)

    cache = DenseCache.zeros(config.net_token, b, t_max, model.dtype, device)
    prev = None
    ended = torch.zeros((b,), dtype=torch.bool, device=device)
    e_off = torch.zeros((b,), dtype=torch.long, device=device)
    toks = []
    for i in range(t_max):
        inp = (hidden.to(model.dtype) if i == 0
               else model.net_token.embed_tokens(prev.long()))
        h, cache = model.net_token(inp[:, None, :], cache)
        probs = torch.softmax(model.logits(h[:, 0]) / temp_b, dim=-1)
        mask = first[None, :] if i == 0 else steps[e_off, i]
        mask = torch.where(ended[:, None], pad_only[None, :], mask)
        if forced_pad is not None:
            mask = torch.where(forced_pad.bool()[:, None], pad_only[None, :], mask)
        probs = probs * mask
        if allow is not None:
            probs = probs * allow.to(probs.dtype)
        if greedy:
            tok = torch.argmax(probs, dim=-1).to(torch.int32)  # first maximum
        else:
            tok = sample(probs.contiguous(), top_p, top_k,
                         gumbel[i * b:(i + 1) * b])
        if i == 0:
            ended = tok == eos_id
            e_off = (tok.long() - first_event_id).clamp(0, n_events - 1)
        prev = tok
        toks.append(tok)
    return torch.stack(toks, dim=1), ended


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def phase_clock(n_barriers: int, device) -> torch.Tensor:
    """A zeroed phase-clock buffer for a launch with ``n_barriers`` grid
    barriers (``csrc/decode.cuh`` ``PhaseSync``): entry 2i is when phase i
    started, 2i + 1 the last block's arrival at its end (%globaltimer ns)."""
    return torch.zeros(2 * n_barriers + 2, dtype=torch.int64, device=device)


def phase_kinds(n_layers: int, n_steps: int) -> list:
    """The kind of each phase of a token-row launch, in order: per step and
    layer norm+qkv, attention, o-proj, gate/up, down; per step lm_head and
    sample."""
    layer = ["norm+qkv", "attention", "o-proj", "gate/up", "down"]
    return (layer * n_layers + ["lm_head", "sample"]) * n_steps


def kernel_limits(config, batch: int) -> Optional[str]:
    """Why the token-row kernel cannot take ``config``'s token net at
    ``batch`` rows, or None when it can."""
    cfg = config.net_token
    h, dh = cfg.num_heads, cfg.head_dim
    t_max = config.tokenizer.max_token_seq
    vocab = config.tokenizer.vocab_size
    if cfg.kv_heads != h or dh % 64 or dh > 256:
        return ("token row kernel: MHA token net, head_dim a multiple of 64 up "
                f"to 256 (got {h} heads x {dh}, {cfg.kv_heads} kv heads)")
    if cfg.num_layers > MAX_LAYERS or t_max > 8 or batch > 256 or vocab > MAX_VOCAB:
        return (f"token row kernel: at most {MAX_LAYERS} layers, 8 steps, 256 "
                f"rows and {MAX_VOCAB} ids (got {cfg.num_layers}, {t_max}, {batch}, "
                f"{vocab})")
    if cfg.hidden_size % 8 or cfg.intermediate_size % 8:
        return (f"token row kernel: widths must be multiples of 8 (D="
                f"{cfg.hidden_size}, F={cfg.intermediate_size})")
    return None


def kernel_args(model, config, hidden: torch.Tensor, masks, temp, top_p, top_k,
                gumbel: Optional[torch.Tensor], *, greedy: bool,
                forced_pad: Optional[torch.Tensor], allow: Optional[torch.Tensor],
                n_events: int, bar: torch.Tensor,
                clock: Optional[torch.Tensor] = None):
    """Check a token-row launch's CUDA inputs and pack them as the kernel's
    host arrays (``csrc/token_row.cuh`` ``fill_token_params``).  gumbel
    [n_events * T*B, k_cap] (None when greedy); bar: a zeroed int32 pair;
    clock: the phase clock (:func:`phase_clock`) or None.
    Returns (ptrs, ints, floats, row [n_events, B, T], ended [B], keep): the
    tensors in ``keep`` must outlive the launch call."""
    first, steps, pad_only = masks
    cfg = config.net_token
    dtype = model.dtype
    device = hidden.device
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"token row: no kernel for {dtype}")
    b, d = hidden.shape
    problem = kernel_limits(config, b)
    if problem:
        raise ValueError(problem)
    if d != cfg.hidden_size:
        raise ValueError(f"token row: hidden width {d}, token net {cfg.hidden_size}")
    h, dh, f = cfg.num_heads, cfg.head_dim, cfg.intermediate_size
    w = h * dh
    n_layers = cfg.num_layers
    t_max = config.tokenizer.max_token_seq
    n_types, _, v = steps.shape
    _build.check(first, "first", torch.bool, (v,))
    _build.check(steps, "steps", torch.bool, (n_types, t_max, v))
    _build.check(pad_only, "pad_only", torch.bool, (v,))

    def weight(t, name, shape):
        _build.check(t, name, dtype, shape)
        return t.data_ptr()

    ptrs = []
    for li in range(MAX_LAYERS):
        if li >= n_layers:
            ptrs += [None] * 9
            continue
        ly = model.net_token.layers[li]
        at, mlp = ly.self_attn, ly.mlp
        ptrs += [weight(at.q_proj.weight, "wq", (w, d)),
                 weight(at.k_proj.weight, "wk", (w, d)),
                 weight(at.v_proj.weight, "wv", (w, d)),
                 weight(at.o_proj.weight, "wo", (d, w)),
                 weight(mlp.gate_proj.weight, "w_gate", (f, d)),
                 weight(mlp.up_proj.weight, "w_up", (f, d)),
                 weight(mlp.down_proj.weight, "w_down", (d, f)),
                 weight(ly.input_layernorm.weight, "ln_attn", (d,)),
                 weight(ly.post_attention_layernorm.weight, "ln_mlp", (d,))]
    cos, sin = rope_cos_sin(torch.arange(t_max, device=device), dh,
                            cfg.rope_theta)
    temp = per_row(temp, b, torch.float32, device)
    top_p = per_row(top_p, b, torch.float32, device)
    top_k = per_row(top_k, b, torch.int32, device)
    if greedy:
        gumbel = None
    else:
        _build.check(gumbel, "gumbel", torch.float32,
                     (n_events * t_max * b, gumbel.shape[-1]))
    if forced_pad is not None:
        forced_pad = forced_pad.to(torch.bool).contiguous()
        _build.check(forced_pad, "forced_pad", torch.bool, (b,))
    if allow is not None:
        allow = allow.to(torch.bool).contiguous()
        _build.check(allow, "allow", torch.bool, (b, v))

    def empty(*shape, dt=dtype):
        return torch.empty(shape, dtype=dt, device=device)

    x = hidden.to(dtype=dtype, copy=True).contiguous()
    scratch = [x, empty(b, 3 * w), empty(b, w), empty(b, f),
               empty(n_layers, t_max, b, w), empty(n_layers, t_max, b, w),
               empty(b, v, dt=torch.float32), empty(b, dt=torch.int32), bar]
    row = empty(n_events, b, t_max, dt=torch.int32)
    ended = empty(b, dt=torch.bool)
    ptrs += [weight(model.net_token.norm.weight, "final_norm", (d,)),
             weight(model.lm_head.weight, "lm_head", (v, d)),
             weight(model.net_token.embed_tokens.weight, "embed", (v, d)),
             cos.data_ptr(), sin.data_ptr(), first.data_ptr(),
             steps.data_ptr(), pad_only.data_ptr(), _ptr(allow),
             _ptr(forced_pad), temp.data_ptr(), top_p.data_ptr(),
             top_k.data_ptr(), _ptr(gumbel)]
    ptrs += [t.data_ptr() for t in scratch] + [row.data_ptr(), ended.data_ptr(),
                                               _ptr(clock)]
    eos_id = config.tokenizer.eos_id
    ints = [b, d, h, dh, f, v, n_layers, t_max, n_types,
            0 if gumbel is None else gumbel.shape[-1], eos_id, eos_id + 1,
            int(greedy)]
    keep = [cos, sin, temp, top_p, top_k, gumbel, forced_pad, allow, *scratch]
    return ptrs, ints, [cfg.rms_norm_eps, dh ** -0.5], row, ended, keep


def decode_token_row(model, config, hidden: torch.Tensor, masks, temp, top_p,
                     top_k, gumbel: Optional[torch.Tensor], *, greedy: bool,
                     forced_pad: Optional[torch.Tensor] = None,
                     allow: Optional[torch.Tensor] = None,
                     clock: Optional[torch.Tensor] = None):
    """Decode one full token row per batch row.

    model: a ``MIDINet``; hidden [B, D]: event-net hidden; masks: (first
    [V], steps [E, T, V], pad_only [V]) bool tensors; ``temp`` / ``top_p`` /
    ``top_k``: scalars or per-row [B]; gumbel [T*B, k_cap] f32 (step-major;
    ignored and may be None when ``greedy``); forced_pad [B] bool and allow
    [B, V] bool, optional.  Returns (row [B, T] int32, ended [B] bool — eos
    emitted at step 0).  CPU tensors run the plain version, CUDA tensors
    the kernel (one launch) or raise.  ``clock`` (CUDA only): a
    :func:`phase_clock` buffer the kernel stamps its phases into."""
    tensors = [hidden, *masks, model.lm_head.weight]
    tensors += [t for t in (temp, top_p, top_k, gumbel, forced_pad, allow)
                if isinstance(t, torch.Tensor)]
    if _build.on_cpu(*tensors):
        return decode_token_row_reference(
            model, config, hidden, masks, temp, top_p, top_k, gumbel,
            greedy=greedy, forced_pad=forced_pad, allow=allow)

    device = hidden.device
    bar = torch.zeros(2, dtype=torch.int32, device=device)
    ptrs, ints, floats, row, ended, keep = kernel_args(
        model, config, hidden, masks, temp, top_p, top_k, gumbel, greedy=greedy,
        forced_pad=forced_pad, allow=allow, n_events=1, bar=bar, clock=clock)
    name = ("mm_token_row_f32" if model.dtype == torch.float32
            else "mm_token_row_bf16")
    _build.count_launch("token_row", _build.call_packed(name, ptrs, ints, floats, device))
    del keep
    return row[0], ended
