"""The hybrid event net (IBM Granite 4.0-H: Mamba-2 and attention layers)
on the CPU at a tiny size, held to the benchmark's plain reference
(``bench_h100/reference/granite_hybrid.py``) and the reference to
``transformers``' ``GraniteMoeHybridModel``: the stack's three paths, the
Mamba-2 kernels' plain versions, the per-slot storage calls the hybrid and
the Llama stacks share, the continuous batcher on the hybrid, the config
round trip, the decode-path rule, and the paths that do not take a
hybrid."""

import copy

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from bench_h100 import spec, weights
from bench_h100.reference import granite_hybrid as ref
from midi_model_tpu_torch.models.config import (HybridConfig, MIDIModelConfig,
                                                TransformerConfig)
from midi_model_tpu_torch.models.midinet import MIDINet, init_model
from midi_model_tpu_torch.ops import event_loop, ssm
from midi_model_tpu_torch.ops.attention import attention_reference, causal_attention, causal_bias
from midi_model_tpu_torch.serve.batcher import ContinuousBatcher
from midi_model_tpu_torch.utils import profiling

from _torch_helpers import one_torch_thread  # noqa: F401 (autouse)

# hidden 64; layers mamba, attention, mamba, mamba; 4 Mamba-2 heads x 16
# (expand 1), state 16, chunk 8; 4 query and 2 kv heads of 16
TINY_NET = dict(model_type="granitemoehybrid", vocab_size=3406, hidden_size=64,
                num_hidden_layers=4, layer_types=["mamba", "attention", "mamba", "mamba"],
                num_attention_heads=4, num_key_value_heads=2, intermediate_size=128,
                shared_intermediate_size=128, mamba_n_heads=4, mamba_d_head=16,
                mamba_d_state=16, mamba_n_groups=1, mamba_d_conv=4, mamba_expand=1,
                mamba_chunk_size=8, mamba_conv_bias=True, mamba_proj_bias=False,
                embedding_multiplier=12.0, residual_multiplier=0.22, attention_multiplier=0.0625,
                logits_scaling=8.0, position_embedding_type="nope", rms_norm_eps=1e-5,
                rope_theta=10000, attention_bias=False, num_local_experts=0,
                num_experts_per_tok=0, normalization_function="rmsnorm", rope_scaling=None,
                hidden_act="silu", tie_word_embeddings=True, max_position_embeddings=4096)

# f32 everywhere: two computations of the same function differ by f32
# rounding of sums taken in other orders (the chunked scan against the
# quadratic form, the paged decode against a full forward), ~1e-6 relative
# through 4 layers; a wrong term (a missed decay step, a pad row counted, a
# state not installed) moves the hidden by 1e-2 or more
F32_TOL = dict(atol=2e-5, rtol=2e-5)


def tiny_bench_config() -> dict:
    c = copy.deepcopy(spec.load_json(spec.HERE / "configs" / "tv2o-granite-h-micro.json"))
    c["net_config"] = dict(TINY_NET)
    c["net_token_config"].update(num_hidden_layers=1, num_attention_heads=1,
                                 num_key_value_heads=1, hidden_size=64, intermediate_size=32)
    c["n_embd"] = 64
    c["dtype"] = "float32"
    return c


@pytest.fixture(scope="module")
def tiny():
    """(bench config, port config, seeded state dict, port model, reference)."""
    c = tiny_bench_config()
    cfg = MIDIModelConfig.from_dict(c)
    state = weights.make(c, 2 ** 31 + 11, torch.float32, "cpu")
    model = MIDINet(cfg, device="cpu")
    model.load_state_dict(state)
    return c, cfg, state, model, ref.MidiModel(c, state)


def random_rows(tok: dict, n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    rows = rng.integers(3, tok["vocab_size"], size=(n, tok["row"]))
    rows[0] = [tok["bos_id"]] + [tok["pad_id"]] * (tok["row"] - 1)
    return rows


def test_reference_matches_transformers(tiny):
    """The reference's event net against HF's ``torch_forward`` path on the
    same weights: f32 on both sides (their SSM sums in other orders)."""
    tr = pytest.importorskip("transformers")
    from transformers.models.granitemoehybrid.modeling_granitemoehybrid import (
        GraniteMoeHybridModel)

    c, _, state, _, reference = tiny
    hf_cfg = tr.GraniteMoeHybridConfig(**{k: v for k, v in TINY_NET.items()
                                          if k != "model_type"})
    hf = GraniteMoeHybridModel(hf_cfg).eval()
    hf.load_state_dict({k[len("net."):]: v for k, v in state.items()
                        if k.startswith("net.")}, strict=True)
    emb = torch.randn(2, 21, 64, generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        want = hf(inputs_embeds=emb).last_hidden_state
    torch.testing.assert_close(reference.net(emb), want, **F32_TOL)


def test_quadratic_form_matches_the_recurrence():
    """The reference's masked-decay form against the recurrence run one row
    at a time (f32; 2 groups of heads)."""
    g = torch.Generator().manual_seed(5)
    s, h, p, n = 19, 4, 8, 6
    x, b, c = (torch.randn(1, s, h, p, generator=g), torch.randn(1, s, 2, n, generator=g),
               torch.randn(1, s, 2, n, generator=g))
    dt = F.softplus(torch.randn(1, s, h, generator=g))
    a, d = -torch.rand(h, generator=g) * 4, torch.randn(h, generator=g)
    per_head = [0, 0, 1, 1]
    want = ref.sequential_ssm(x[0], b[0][:, per_head], c[0][:, per_head], dt[0], a, d)
    torch.testing.assert_close(ref.ssd_quadratic(x, b, c, dt, a, d)[0], want, **F32_TOL)


@pytest.mark.parametrize("chunk", [4, 8, 32])
def test_plain_scan_matches_the_recurrence(chunk):
    """``ops.ssm.ssm_scan`` (CPU: the plain chunked form) on a bucket of
    prompts of 1, 2, 5 and 20 rows: each prompt's y at its rows, zeros past
    them, and its final state, against the recurrence over the prompt
    alone."""
    g = torch.Generator().manual_seed(7)
    lengths, s, h, p, n = [1, 2, 5, 20], 24, 4, 8, 6
    x = torch.randn(4, s, h, p, generator=g)
    b, c = torch.randn(4, s, 1, n, generator=g), torch.randn(4, s, 1, n, generator=g)
    dt = F.softplus(torch.randn(4, s, h, generator=g))
    a, d = -torch.rand(h, generator=g) * 4, torch.randn(h, generator=g)
    y, state = ssm.ssm_scan(x, b, c, dt, a, d, torch.tensor(lengths, dtype=torch.int32),
                            chunk=chunk)
    for i, L in enumerate(lengths):
        bb, cc = b[i, :L].expand(L, h, n), c[i, :L].expand(L, h, n)
        want = ref.sequential_ssm(x[i, :L], bb, cc, dt[i, :L], a, d)
        torch.testing.assert_close(y[i, :L], want, **F32_TOL)
        assert bool((y[i, L:] == 0).all())
        st = torch.zeros(h, p, n)
        for t in range(L):
            st = (torch.exp(dt[i, t] * a)[:, None, None] * st
                  + (dt[i, t][:, None] * x[i, t])[..., None] * b[i, t, 0][None, None, :])
        torch.testing.assert_close(state[i], st, **F32_TOL)


def test_plain_step_continues_the_scan():
    """``ops.ssm.ssm_step`` (CPU: the plain version), after a prompt's
    convolution and scan, gives the next row of the whole sequence's scan:
    its gated output, its SSM state and its conv state (the last 3
    pre-convolution rows, zeros before a prompt shorter than 3)."""
    g = torch.Generator().manual_seed(9)
    h, p, n, k = 4, 8, 6, 4
    inner, conv = h * p, h * p + 2 * n
    conv_w, conv_b = torch.rand(conv, 1, k, generator=g) - 0.5, torch.rand(conv, generator=g) - 0.5
    dt_bias, a_log = torch.rand(h, generator=g) - 3.0, torch.rand(h, generator=g)
    d, norm_w = torch.randn(h, generator=g), torch.rand(inner, generator=g) + 0.5
    for L in (1, 2, 6):
        rows = torch.randn(1, L + 1, inner + conv + h, generator=g)
        z, xbc, dt = ssm.split_projection(rows, inner, conv)

        def scan(upto):
            lens = torch.tensor([upto], dtype=torch.int32)
            xc, conv_state = ssm.causal_conv(xbc[:, :upto], conv_w, conv_b, lens)
            dtv = F.softplus(dt[:, :upto] + dt_bias)
            y, st = ssm.ssm_scan(xc[..., :inner].reshape(1, upto, h, p),
                                 xc[..., inner:inner + n].reshape(1, upto, 1, n),
                                 xc[..., inner + n:].reshape(1, upto, 1, n), dtv,
                                 -torch.exp(a_log), d, lens, chunk=4)
            return ssm.gated_rms_norm(y.reshape(1, upto, inner), z[:, :upto], norm_w, 1e-5), \
                st, conv_state

        _, st, conv_state = scan(L)
        out = ssm.ssm_step(rows[:, L], conv_state, st, conv_w, conv_b, dt_bias, a_log, d,
                           norm_w, 1e-5, groups=1)
        want_out, want_st, want_conv = scan(L + 1)
        torch.testing.assert_close(out, want_out[:, L], **F32_TOL)
        torch.testing.assert_close(st, want_st, **F32_TOL)
        torch.testing.assert_close(conv_state, want_conv, rtol=0, atol=0)


@pytest.mark.parametrize("kv_split", [1, 2])
def test_stack_paths_match_the_reference(tiny, kv_split, monkeypatch):
    """``HybridStack.forward``; ``prefill_paged`` of one bucket holding
    prompts of 1, 2, 5 and 20 rows (shorter than the convolution, across
    chunks of 8), which installs the states into their slots over what
    they held; then ``decode_paged`` of 6 rows through both caches: each
    against the reference's full forward of the prompt and its rows so far.
    With ``kv_split`` 2 each slot's kv heads lie in two virtual slots of the
    pools, as granite's 32 query heads do on the card."""
    _, _, _, model, reference = tiny
    net = model.net
    monkeypatch.setattr(net, "kv_split", kv_split)
    g = torch.Generator().manual_seed(11)
    lengths, s, steps = [1, 2, 5, 20], 24, 6
    emb = torch.randn(4, s + steps, 64, generator=g)
    with torch.no_grad():
        torch.testing.assert_close(net(emb[:, :s])[0], reference.net(emb[:, :s]), **F32_TOL)
        ps, pps = 4, 8
        storage = net.alloc_storage(4, pps, ps)
        assert storage.graph is None  # the CPU runs the step op by op
        storage.state.ssm.normal_()  # whatever the slots held before
        storage.state.conv.normal_()
        slots = torch.tensor([2, 0, 3, 1])
        lens = torch.tensor(lengths, dtype=torch.int32)
        # prompt g's rows, then its decoded rows: the rows of emb after its length
        seqs = [torch.cat([emb[i, :L], emb[i, s:]]) for i, L in enumerate(lengths)]
        padded = torch.stack([F.pad(q[:L], (0, 0, 0, s - L)) for q, L in zip(seqs, lengths)])
        hidden, storage = net.prefill_paged(padded, storage, page_size=ps, pages_per_slot=pps,
                                            slots=slots, n_slots=4, lengths=lens)
        for i, L in enumerate(lengths):
            torch.testing.assert_close(hidden[i, :L], reference.net(seqs[i][None, :L])[0],
                                       **F32_TOL)
        index = torch.zeros(4, dtype=torch.int32)
        index[slots] = lens
        for t in range(steps):
            x = torch.zeros(4, 64)
            x[slots] = torch.stack([q[L + t] for q, L in zip(seqs, lengths)])
            out, storage = net.decode_paged(x, storage, index, torch.ones(4, dtype=torch.bool),
                                            page_size=ps, pages_per_slot=pps)
            for i, L in enumerate(lengths):
                want = reference.net(seqs[i][None, :L + t + 1])[0, -1]
                torch.testing.assert_close(out[slots[i]], want, **F32_TOL)
            index = index + 1


@pytest.mark.parametrize("stack", ["llama", "hybrid"])
def test_stacks_share_the_storage_calls(tiny, stack):
    """Both event nets through the three calls a caller makes: storage for
    4 slots, one prefill of prompts of 1, 2, 5 and 20 rows into shuffled
    slots, then 3 decoded rows per slot.  Each slot's hidden rows equal
    those of its prompt admitted alone into storage of its own."""
    if stack == "hybrid":
        model = tiny[3]
    else:
        model = init_model(MIDIModelConfig.get_config("v2", True, n_layer=2, n_head=4,
                                                      n_embd=64, n_inner=128),
                           seed=3, device="cpu")
    net = model.net
    g = torch.Generator().manual_seed(17)
    lengths, s, steps, ps, pps = [1, 2, 5, 20], 24, 3, 4, 8
    seqs = [torch.randn(L + steps, 64, generator=g) for L in lengths]

    def run(prompts, slots, n_slots):
        """(each prompt's prefill rows, its decoded rows [steps, D])."""
        storage = net.alloc_storage(n_slots, pps, ps)
        lens = [len(q) - steps for q in prompts]
        bucket = max(lens) if n_slots == 1 else s
        padded = torch.stack([F.pad(q[:L], (0, 0, 0, bucket - L)) for q, L in zip(prompts, lens)])
        slots_t = torch.tensor(slots)
        hidden, storage = net.prefill_paged(padded, storage, slots=slots_t, n_slots=n_slots,
                                            lengths=np.asarray(lens), page_size=ps,
                                            pages_per_slot=pps)
        index = torch.zeros(n_slots, dtype=torch.int32)
        index[slots_t] = torch.tensor(lens, dtype=torch.int32)
        decoded = []
        for t in range(steps):
            x = torch.zeros(n_slots, 64)
            x[slots_t] = torch.stack([q[L + t] for q, L in zip(prompts, lens)])
            out, storage = net.decode_paged(x, storage, index,
                                            torch.ones(n_slots, dtype=torch.bool),
                                            page_size=ps, pages_per_slot=pps)
            decoded.append(out[slots_t].clone())
            index = index + 1
        return ([hidden[i, :L] for i, L in enumerate(lens)],
                torch.stack(decoded, dim=1))

    with torch.no_grad():
        together, decoded = run(seqs, [2, 0, 3, 1], 4)
        for i, q in enumerate(seqs):
            alone, alone_decoded = run([q], [0], 1)
            torch.testing.assert_close(together[i], alone[0], **F32_TOL)
            torch.testing.assert_close(decoded[i], alone_decoded[0], **F32_TOL)


CASES = {  # (event net, weights, kv_int8, fused, model axis) -> path or the error raised
    ("wide", "bfloat16", False, None, False): "event_loop",
    ("wide", "bfloat16", True, None, False): "pair",
    ("wide", "float32", False, None, False): "split",
    ("wide", "float32", False, True, False): "event_loop",
    ("wide", "float32", True, True, False): "pair",
    ("wide", "bfloat16", False, False, False): "split",
    ("wide", "bfloat16", True, False, False): "split",
    ("wide", "bfloat16", False, None, True): "split",
    ("wide", "bfloat16", True, False, True): "split",
    ("wide", "bfloat16", False, True, True): "all-reduce",
    ("narrow", "bfloat16", False, None, False): "split",
    ("narrow", "bfloat16", True, True, False): "pair",
    ("hybrid", "bfloat16", False, None, False): "split",
    ("hybrid", "float32", False, False, False): "split",
    ("hybrid", "bfloat16", True, None, False): "split",
    ("hybrid", "float32", False, True, False): "hybrid event net",
}


@pytest.mark.parametrize("case", list(CASES), ids=lambda case: "-".join(map(str, case)))
def test_decode_path_rule(tiny, case):
    """``ops.event_loop.decode_path``, the batcher's and ``generate``'s one
    rule, at 2 slots of 64 rows: ``fused=None`` takes the fused kernels for
    bf16 weights where they take the model (the ragged event loop, or the
    pair on int8 pools), never for f32 weights, a packed-MHA miss
    (``narrow``: 4 heads of 16) or a hybrid; a model axis takes the split
    scan; ``fused`` True forces the kernels, and raises under a model axis
    or on a hybrid (whose int8 pools its storage refuses)."""
    net, dtype, kv_int8, fused, sharded = case
    config = {"wide": MIDIModelConfig.get_config("v2", True, n_layer=1, n_head=8, n_embd=512,
                                                 n_inner=64),
              "narrow": MIDIModelConfig.get_config("v2", True, n_layer=4, n_head=4, n_embd=64,
                                                   n_inner=128),
              "hybrid": tiny[1]}[net]
    args = (config, getattr(torch, dtype), 2, 64, kv_int8, fused, object() if sharded else None)
    want = CASES[case]
    if want in ("event_loop", "pair", "split"):
        assert event_loop.decode_path(*args) == want
    else:
        with pytest.raises(ValueError, match=want):
            event_loop.decode_path(*args)


def test_batcher_serves_the_hybrid_on_the_split_scan(tiny):
    """``ContinuousBatcher`` on the hybrid: the split scan, pools for the
    attention layer only, per-slot state; a seeded greedy request's rows are
    the same alone and among other requests (other slots, other buckets),
    and they are the reference's greedy rows under the grammar masks."""
    c, cfg, _, model, reference = tiny
    tok = c["tokenizer"]
    prompt = random_rows(tok, 5, 1)
    prompt[1:] = 0
    prompt[1:, 0] = 3  # grammar does not matter to the model: any rows
    alone = ContinuousBatcher(model, cfg, n_slots=4, max_seq=64, chunk=3, greedy=True,
                              page_size=4, disable_eos=True)
    assert alone.path == "split" and alone._storage.graph is None
    pools, state = alone._storage.pools, alone._storage.state
    assert pools.k.shape[0] == 1 * 4 * alone.pages_per_slot  # 1 attention layer
    assert state.ssm.shape == (3, 4, 4, 16, 16)
    assert state.conv.shape == (3, 4, 3, 64 + 2 * 16)
    rid = alone.submit(prompt, 7, seed=5)
    rows = alone.run_all()[rid].rows
    mixed = ContinuousBatcher(model, cfg, n_slots=4, max_seq=64, chunk=3, greedy=True,
                              page_size=4, disable_eos=True)
    others = [mixed.submit(random_rows(tok, n, n), 9, seed=n) for n in (2, 30)]
    rid2 = mixed.submit(prompt, 7, seed=5)
    got = mixed.run_all()
    np.testing.assert_array_equal(got[rid2].rows, rows)
    assert all(len(got[r].rows) == 9 for r in others)
    # the reference's greedy rows: logits teacher-forced through the reference
    from bench_h100.reference.judge import ServedRequest, serve_readings

    readings = serve_readings(c, dict(reference.w), [ServedRequest(prompt, rows)], "cpu")
    assert readings["logit_gap"] < 1e-3 and readings["tokens"] == 7 * tok["row"]


def test_batcher_records_state_install_and_scan_counters(tiny):
    """The recorder's ``batcher.state_install`` span (rids, bytes) and the
    ``batcher.ssm_scan_rows`` / ``_pad_rows`` counters on the hybrid,
    recorded by its prefill inside the batcher's admission."""
    c, cfg, _, model, _ = tiny
    tok = c["tokenizer"]
    b = ContinuousBatcher(model, cfg, n_slots=4, max_seq=64, chunk=2, greedy=True,
                          page_size=4)
    with profiling.recording():
        rids = [b.submit(random_rows(tok, n, n), 4) for n in (3, 10)]
        b.run_all()
        spans, counters = profiling.snapshot()
    installs = [sp for sp in spans if sp.name == "batcher.state_install"]
    assert sorted(r for sp in installs for r in sp.attrs["rids"]) == sorted(rids)
    per_slot = b._storage.state.nbytes() // 4
    assert sum(sp.attrs["bytes"] for sp in installs) == 2 * per_slot
    # buckets of 16 rows (one prompt each); chunks of 8: 8 and 16 rows ran
    assert counters["batcher.ssm_scan_rows"] == 8 + 16
    assert counters["batcher.ssm_scan_pad_rows"] == 8 + 16 - 3 - 10


def test_config_round_trip_and_unknown_model_type():
    """A granite net config reads back to itself and writes the published
    keys; Llama configs write what they wrote; an unknown model_type
    raises instead of building a Llama."""
    net = HybridConfig.from_hf_dict(TINY_NET)
    assert net.to_hf_dict() == TINY_NET
    assert HybridConfig.from_hf_dict(net.to_hf_dict()) == net
    assert net.attention_layers == (1,) and net.mamba_layers == (0, 2, 3)
    published = spec.load_json(spec.HERE / "configs" / "tv2o-granite-h-micro.json")
    full = TransformerConfig.from_hf_dict(published["net_config"])
    assert isinstance(full, HybridConfig) and full.to_hf_dict() == published["net_config"]
    assert (full.num_layers, full.conv_dim, len(full.mamba_layers)) == (40, 4352, 36)
    cfg = MIDIModelConfig.from_name("tv2o-medium")
    back = MIDIModelConfig.from_dict(cfg.to_dict())
    assert back.to_dict() == cfg.to_dict() and type(back.net) is TransformerConfig
    for bad in ("mistral", "granitemoe"):
        with pytest.raises(ValueError, match="unknown model_type"):
            TransformerConfig.from_hf_dict(dict(TINY_NET, model_type=bad))
    with pytest.raises(ValueError, match="layer_types"):
        HybridConfig.from_hf_dict(dict(TINY_NET, layer_types=["mamba"]))


def test_attention_scale_leaves_the_default_bit_identical():
    """``causal_attention``'s optional ``scale``: omitted, or given as
    ``Dh**-0.5``, the output is the default's to the bit; another scale is
    the plain attention of q scaled by it over ``Dh**-0.5``."""
    g = torch.Generator().manual_seed(13)
    q, k, v = (torch.randn(2, 9, 4, 16, generator=g), torch.randn(2, 9, 2, 16, generator=g),
               torch.randn(2, 9, 2, 16, generator=g))
    base = causal_attention(q, k, v)
    assert torch.equal(base, attention_reference(q, k, v, causal_bias(9, q.device)))
    assert torch.equal(causal_attention(q, k, v, scale=16 ** -0.5), base)
    scaled = causal_attention(q, k, v, scale=0.0625)
    torch.testing.assert_close(scaled, causal_attention(q * (0.0625 / 0.25), k, v), **F32_TOL)
    with pytest.raises(ValueError, match="default scale"):
        causal_attention(q.requires_grad_(), k, v, scale=0.0625)


@pytest.mark.parametrize("path", ["kv_int8", "mesh", "fused", "train", "lora", "lora_load",
                                  "export", "generate"])
def test_paths_left_out_raise(tiny, path, tmp_path):
    """Int8 pools, a mesh, the fused kernels, training, LoRA, export and
    ``generate`` do not take a hybrid event net: each raises a clear
    error."""
    _, cfg, _, model, _ = tiny
    if path in ("kv_int8", "mesh", "fused"):
        from midi_model_tpu_torch.parallel.mesh import Mesh

        mesh = Mesh(dp=1, tp=1, data_rank=0, model_rank=0, data_group=None, model_group=None,
                    host_group=None, device=torch.device("cpu"))
        kw = {"kv_int8": dict(kv_int8=True), "mesh": dict(mesh=mesh),
              "fused": dict(fused=True)}[path]
        with pytest.raises(ValueError, match="hybrid event net"):
            ContinuousBatcher(model, cfg, n_slots=2, max_seq=64, **kw)
        return
    with pytest.raises(ValueError, match="hybrid event net"):
        if path in ("train", "lora"):
            from midi_model_tpu_torch.train.trainer import (make_lora_train_step,
                                                            make_optimizer, make_train_step)

            make = make_train_step if path == "train" else make_lora_train_step
            make(cfg, make_optimizer())
        elif path == "lora_load":
            from midi_model_tpu_torch.models.lora import peft_state_dict_to_lora

            peft_state_dict_to_lora({}, cfg)
        elif path == "generate":
            from midi_model_tpu_torch.sampling import generate

            generate(model, cfg, max_len=4)
        else:
            from midi_model_tpu_torch.interop.export import export_artifacts

            export_artifacts(model, cfg, str(tmp_path))
