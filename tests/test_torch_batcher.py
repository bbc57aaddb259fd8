"""The port's continuous batcher (``midi_model_tpu_torch.serve.batcher``) on
the CPU, mirroring ``tests/test_batcher.py``, ``_seed``, ``_pipeline`` and
``_merged``, and held to the JAX package's batcher.

Greedy rows are compared with the JAX batcher (its split scan on the CPU)
on the same f32 weights, with bf16/f32 and with int8 pools: random bf16
weights make greedy picks near-ties that a one-step rounding difference
decides.  Sampled rows draw the port's own per-slot noise
(``sampling.slot_gumbel``), not ``jax.random``'s, so they are held to the
port's own invariances: a seeded request's rows do not depend on its slot,
its co-tenants, the chunk size, the decode path (the ragged event loop or
the split scan) or the pipeline."""

import numpy as np
import pytest
import torch

from midi_model_tpu.serve.batcher import ContinuousBatcher as JaxBatcher
from midi_model_tpu_torch.interop import params_from_state_dict, synthesize_state_dict
from midi_model_tpu_torch.models import MIDIModelConfig
from midi_model_tpu_torch.models.midinet import init_model
from midi_model_tpu_torch.sampling import generate, slot_gumbel
from midi_model_tpu_torch.serve import batcher as bt
from midi_model_tpu_torch.serve import ContinuousBatcher

from _torch_helpers import layout, one_torch_thread, tiny_models  # noqa: F401 (autouse)

# the ragged event loop's geometry: 4 heads x 128, packed pages
MERGED = dict(n_layer=4, n_head=4, n_embd=512, n_inner=256)


@pytest.fixture(scope="module")
def tiny():
    jcfg, cfg, params, model, _ = tiny_models(seed=0)
    return jcfg, cfg, params, model


@pytest.fixture(scope="module")
def merged_model():
    cfg = MIDIModelConfig.get_config("v2", True, **MERGED)
    return cfg, params_from_state_dict(synthesize_state_dict(layout(cfg), 1), cfg,
                                       device="cpu")


def bos_prompt(tok, extra=0):
    rows = [[tok.bos_id] + [tok.pad_id] * (tok.max_token_seq - 1)]
    for i in range(extra):
        rows.append(tok.event2tokens(["set_tempo", 0, 0, 0, 100 + i]))
    return np.asarray(rows, np.int32)


def drive(model, cfg, plan, *, max_steps=200, on_rows=None, **kw):
    """Run a session; plan = [(submit_at_step, prompt, budget, submit_kw)].
    Returns ({request id: Finished}, request ids in plan order)."""
    b = ContinuousBatcher(model, cfg, **kw)
    pending = sorted(plan, key=lambda p: p[0])
    ids, results = [], {}
    for step_i in range(max_steps):
        while pending and pending[0][0] <= step_i:
            _, prompt, budget, skw = pending.pop(0)
            ids.append(b.submit(prompt, max_events=budget, **skw))
        if not b.any_active and not pending:
            break
        results.update((f.request_id, f) for f in b.step(on_rows=on_rows))
    assert not pending and not b.any_active, "session did not drain"
    return results, ids


def test_single_request_matches_generate_and_jax_batcher(tiny):
    """One slot, greedy: the aligned ``generate`` and the JAX batcher."""
    jcfg, cfg, params, model = tiny
    tok = cfg.tokenizer
    prompt = bos_prompt(tok)
    ref = generate(model, cfg, prompt=prompt.astype(np.int64), batch_size=1, max_len=9,
                   greedy=True)[0, 1:]
    b = ContinuousBatcher(model, cfg, n_slots=2, max_seq=64, chunk=4, greedy=True)
    assert b.device.type == "cpu" and not b.pipeline and not b.fused
    rid = b.submit(prompt, max_events=8)
    got = b.run_all()[rid].rows
    jb = JaxBatcher(params, jcfg, n_slots=2, max_seq=64, chunk=4, greedy=True)
    jrid = jb.submit(prompt, max_events=8)
    np.testing.assert_array_equal(got, jb.run_all()[jrid].rows)
    n = min(len(got), len(ref))
    assert n > 0
    np.testing.assert_array_equal(got[:n], ref[:n])


@pytest.mark.parametrize("kv_int8", [False, True], ids=["f32_pools", "int8_pools"])
def test_staggered_greedy_rows_match_jax_batcher(tiny, kv_int8):
    """Requests with different prompts and budgets, one queued behind the
    two slots and admitted into a freed one: every request's greedy rows and
    finish reason equal the JAX batcher's."""
    jcfg, cfg, params, model = tiny
    tok = cfg.tokenizer
    reqs = [(bos_prompt(tok), 5), (bos_prompt(tok, 2), 7), (bos_prompt(tok, 1), 4)]
    kw = dict(n_slots=2, max_seq=64, chunk=3, greedy=True, kv_int8=kv_int8)
    ours = ContinuousBatcher(model, cfg, **kw)
    theirs = JaxBatcher(params, jcfg, **kw)
    rids = [(ours.submit(p, n), theirs.submit(p, n)) for p, n in reqs]
    got, ref = ours.run_all(), theirs.run_all()
    for (r, jr), (_, budget) in zip(rids, reqs):
        np.testing.assert_array_equal(got[r].rows, ref[jr].rows)
        assert got[r].reason == ref[jr].reason
        assert len(got[r].rows) <= budget


def test_staggered_sampled_requests_finish_grammatical(tiny):
    _, cfg, _, model = tiny
    tok = cfg.tokenizer
    b = ContinuousBatcher(model, cfg, n_slots=2, max_seq=64, chunk=3, seed=7)
    budgets = {b.submit(bos_prompt(tok), 5): 5, b.submit(bos_prompt(tok, 2), 7): 7,
               b.submit(bos_prompt(tok, 1), 4): 4}  # the third is queued
    results = b.run_all()
    assert set(results) == set(budgets)
    for rid, budget in budgets.items():
        fin = results[rid]
        assert fin.reason in ("eos", "budget") and len(fin.rows) <= budget
        if fin.reason == "budget":
            assert len(fin.rows) == budget
        for row in fin.rows:
            assert tok.tokens2event(list(row)) or row[0] in (tok.pad_id, tok.eos_id)


def test_slot_reuse_after_finish(tiny):
    _, cfg, _, model = tiny
    tok = cfg.tokenizer
    b = ContinuousBatcher(model, cfg, n_slots=1, max_seq=64, chunk=2, seed=3)
    r1 = b.submit(bos_prompt(tok), max_events=3)
    assert r1 in b.run_all()
    r2 = b.submit(bos_prompt(tok, extra=1), max_events=3)
    assert r2 in b.run_all() and not b.any_active


def test_per_request_constraints_share_batch(tiny):
    """Different bans share one batch: the banned ids never appear in the
    constrained stream, the unconstrained neighbour's stream is the same as
    alone, and a retired slot drops its ban."""
    _, cfg, _, model = tiny
    tok = cfg.tokenizer
    v = tok.vocab
    kw = dict(n_slots=2, max_seq=64, chunk=4, seed=11, disable_eos=True)
    solo = ContinuousBatcher(model, cfg, **kw)
    r_solo = solo.submit(bos_prompt(tok), max_events=6)
    ref_rows = solo.run_all()[r_solo].rows

    both = ContinuousBatcher(model, cfg, **kw)
    r_plain = both.submit(bos_prompt(tok), max_events=6)
    banned = [0, 2, 5]
    r_banned = both.submit(bos_prompt(tok), max_events=6, disable_patch_change=True,
                           disable_control_change=True, disable_channels=banned)
    results = both.run_all()
    np.testing.assert_array_equal(results[r_plain].rows, ref_rows)
    banned_ids = {v.event_ids["patch_change"], v.event_ids["control_change"]}
    banned_ids |= {v.param_base("channel") + c for c in banned}
    seen = set(np.asarray(results[r_banned].rows).ravel().tolist())
    assert len(results[r_banned].rows) > 0 and not (seen & banned_ids)
    both.submit(bos_prompt(tok), max_events=3)
    both.run_all()
    assert both._allow.all()


def test_grouped_prefill_matches_per_request(tiny, monkeypatch):
    """An admission wave of same-bucket requests in one prefill forward
    gives every request the rows of one prefill per request."""
    _, cfg, _, model = tiny
    tok = cfg.tokenizer
    prompts = [bos_prompt(tok), bos_prompt(tok, 2), bos_prompt(tok, 1),
               bos_prompt(tok, 3), bos_prompt(tok)]
    groups = []
    real = ContinuousBatcher._prefill_group

    def counted(self, bucket, part):
        groups.append(len(part))
        return real(self, bucket, part)

    monkeypatch.setattr(ContinuousBatcher, "_prefill_group", counted)

    def run(group):
        monkeypatch.setattr(ContinuousBatcher, "_MAX_PREFILL_GROUP", group)
        b = ContinuousBatcher(model, cfg, n_slots=8, max_seq=64, chunk=4, greedy=True)
        b.queue.extend((i, p.astype(np.int64), 6, (1.0, 0.98, 20), None, i)
                       for i, p in enumerate(prompts))  # one admission wave
        b._next_id = len(prompts)
        b._admit()
        results = b.run_all()
        return [results[i].rows for i in range(len(prompts))]

    grouped = run(8)
    assert groups == [5]
    groups.clear()
    single = run(1)
    assert groups == [1] * 5
    for a, c in zip(grouped, single):
        np.testing.assert_array_equal(a, c)


def _seeded_run(model, cfg, seed, *, companions=0, chunk=3, fused=None, pipeline=None,
                max_events=6):
    tok = cfg.tokenizer
    plan = [(0, bos_prompt(tok, extra=i % 3), max_events, dict(seed=99 + i))
            for i in range(companions)]
    plan.append((0, bos_prompt(tok), max_events, dict(seed=seed)))
    results, ids = drive(model, cfg, plan, n_slots=4, max_seq=64, chunk=chunk, temp=1.0,
                         top_p=1.0, top_k=8, seed=0, disable_eos=True, page_size=16,
                         fused=fused, pipeline=pipeline)
    return results[ids[-1]].rows


def test_seed_reproduces_across_compositions_chunks_and_paths(merged_model):
    """Position-keyed noise: one seeded request gives the same rows alone
    or beside three others (another slot), at chunk 2 or 5, through the
    ragged event loop or the split scan; another seed gives other rows."""
    cfg, model = merged_model
    alone = _seeded_run(model, cfg, 42, fused=True)
    assert len(alone) == 6
    np.testing.assert_array_equal(alone, _seeded_run(model, cfg, 42, companions=3, fused=True))
    np.testing.assert_array_equal(alone, _seeded_run(model, cfg, 42, chunk=5, fused=True))
    np.testing.assert_array_equal(alone, _seeded_run(model, cfg, 42, fused=False))
    assert not np.array_equal(alone, _seeded_run(model, cfg, 43, fused=True))


def test_unseeded_requests_are_deterministic_per_batcher(tiny):
    _, cfg, _, model = tiny
    tok = cfg.tokenizer

    def go():
        b = ContinuousBatcher(model, cfg, n_slots=2, max_seq=64, chunk=3, top_p=1.0,
                              top_k=8, seed=5, disable_eos=True)
        rid = b.submit(bos_prompt(tok), max_events=5)
        return b.run_all()[rid].rows

    np.testing.assert_array_equal(go(), go())


def test_slot_gumbel_is_keyed_by_seed_and_position():
    """The noise of (seed, position) does not depend on the slot, the
    batch or the chunk; it is standard Gumbel."""
    seeds = torch.tensor([7, 8, 7], dtype=torch.int64)
    pos = torch.tensor([[4, 4, 9], [5, 5, 10]])
    g = slot_gumbel(seeds, pos, 8).view(2, 8, 3, -1)  # [event, step, slot, k]
    alone = slot_gumbel(torch.tensor([7]), torch.tensor([[5]]), 8).view(8, -1)
    assert torch.equal(g[1, :, 0], alone)  # seed 7 at position 5, in a batch of 3
    assert not torch.equal(g[0, :, 0], g[0, :, 1])  # another seed
    assert not torch.equal(g[0, :, 0], g[1, :, 0])  # another position
    big = slot_gumbel(torch.arange(64), torch.arange(64)[None] * 3, 8)
    assert abs(float(big.mean()) - 0.5772) < 0.02 and abs(float(big.std()) - 1.2825) < 0.02
    assert bool(torch.isfinite(big).all())


PLAN = [  # (step, prompt extra, budget, seed): staggered admissions and churn
    (0, 0, 5, 11), (0, 1, 9, 22), (1, 0, 4, 33), (3, 2, 7, 44), (4, 0, 3, 55)]


@pytest.mark.parametrize("greedy", [False, True], ids=["sampled", "greedy"])
def test_pipeline_matches_nonpipelined(tiny, greedy):
    """One chunk in flight: every request's rows and reason are the same,
    and the streamed rows are the final rows."""
    _, cfg, _, model = tiny
    tok = cfg.tokenizer
    plan = [(s, bos_prompt(tok, e), n, dict(seed=sd)) for s, e, n, sd in PLAN]
    kw = dict(n_slots=2, max_seq=64, chunk=3, top_p=1.0, top_k=8, greedy=greedy)
    ref, ids0 = drive(model, cfg, plan, pipeline=False, **kw)
    streamed = {}
    got, ids1 = drive(model, cfg, plan, pipeline=True,
                      on_rows=lambda rid, rows: streamed.setdefault(rid, []).append(rows),
                      **kw)
    assert ids0 == ids1 and set(ref) == set(got)
    for rid in ref:
        np.testing.assert_array_equal(ref[rid].rows, got[rid].rows)
        assert ref[rid].reason == got[rid].reason
        if len(got[rid].rows):
            np.testing.assert_array_equal(np.concatenate(streamed[rid]), got[rid].rows)


@pytest.mark.parametrize("pipeline", [False, True], ids=["plain", "pipelined"])
def test_capacity_retirement_invariant_to_the_chunk(merged_model, pipeline):
    """A slot that reaches the capacity mid-chunk retires the same way
    wherever the chunk boundaries fall: decoded exactly to the capacity,
    reason "budget"; through the ragged event loop."""
    cfg, model = merged_model
    tok = cfg.tokenizer
    plan = [(0, bos_prompt(tok, 2), 10**6, {}), (0, bos_prompt(tok), 5, {})]
    kw = dict(n_slots=2, max_seq=32, page_size=8, greedy=True, disable_eos=True,
              fused=True, pipeline=pipeline)
    ref, ids = drive(model, cfg, plan, chunk=5, **kw)
    got, _ = drive(model, cfg, plan, chunk=4, **kw)
    for rid in ref:
        np.testing.assert_array_equal(got[rid].rows, ref[rid].rows)
        assert got[rid].reason == ref[rid].reason
    assert ref[ids[0]].reason == "budget" and len(ref[ids[0]].rows) == 32 - 3


def test_fused_rule_and_int8(tiny, merged_model):
    """``fused=None`` takes the fused kernels for bf16 weights where they
    take the model, never for f32 weights: the ragged event loop on bf16
    pools, the per-event pair on int8 pools; the pair needs packed MHA."""
    _, cfg, _, model = tiny
    assert not ContinuousBatcher(model, cfg, n_slots=2, max_seq=64).fused
    mcfg = merged_model[0]
    # the merged geometry's token net (1 head x 512) is outside the token-row
    # kernel's limits, so fused=None keeps the split scan even in bf16; a
    # token net of 2 heads x 256 is inside them
    bf16 = init_model(mcfg, dtype=torch.bfloat16, device="cpu")
    assert not ContinuousBatcher(bf16, mcfg, n_slots=2, max_seq=64).fused
    wide = MIDIModelConfig.get_config("v2", True, n_layer=1, n_head=8, n_embd=512, n_inner=64)
    fused = ContinuousBatcher(init_model(wide, dtype=torch.bfloat16, device="cpu"), wide,
                              n_slots=2, max_seq=64)
    assert fused.fused and fused._weights is not None and fused.path == "event_loop"
    pair = ContinuousBatcher(init_model(wide, dtype=torch.bfloat16, device="cpu"), wide,
                             n_slots=2, max_seq=64, kv_int8=True)
    assert pair.fused and pair.path == "pair"
    unpacked = ContinuousBatcher(model, cfg, n_slots=2, max_seq=64, kv_int8=True, fused=True)
    unpacked.submit(bos_prompt(cfg.tokenizer), 4)
    with pytest.raises(ValueError, match="head_stride"):  # 4 heads x 16: stride 32
        unpacked.step()
    assert bt.PREFILL_BUCKETS == (16, 64, 256, 1024, 4096)
    b = ContinuousBatcher(model, cfg, n_slots=2, max_seq=100)
    assert b.max_seq == 256 and b.pages_per_slot == 4  # rounded to 4 pages of 64


@pytest.mark.parametrize("chunk", [3, 5])
def test_int8_pair_matches_generate(merged_model, chunk):
    """int8 pools through the per-event pair (``fused=True``; token row,
    then the whole step over the int8 pools, f32 weights): one greedy
    request's rows equal ``generate(kv_int8=True, fused=True)``'s — the same
    plain versions —, at either chunk size, and two staggered requests
    beside it finish with the rows they decode alone."""
    cfg, model = merged_model
    tok = cfg.tokenizer
    prompt = bos_prompt(tok, 1)
    kw = dict(n_slots=2, max_seq=64, chunk=chunk, greedy=True, kv_int8=True, fused=True)
    ref = generate(model, cfg, prompt=prompt.astype(np.int64), batch_size=1, max_len=10,
                   greedy=True, kv_int8=True, fused=True)[0, 2:]
    b = ContinuousBatcher(model, cfg, **kw)
    assert b.path == "pair"
    rid = b.submit(prompt, max_events=8)
    got = b.run_all()[rid].rows
    n = min(len(got), len(ref))
    assert n > 0
    np.testing.assert_array_equal(got[:n], ref[:n])
    plan = [(0, bos_prompt(tok, 1), 8, {}), (1, bos_prompt(tok, 2), 6, {})]
    together, ids = drive(model, cfg, plan, **kw)
    np.testing.assert_array_equal(together[ids[0]].rows, got)
    alone, _ = drive(model, cfg, plan[1:], **kw)
    np.testing.assert_array_equal(together[ids[1]].rows, next(iter(alone.values())).rows)
