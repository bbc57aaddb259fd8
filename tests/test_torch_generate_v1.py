"""The v1-tokenizer model family in the port, mirroring
``tests/test_generate_v1.py``: the v1 vocab and mask tables equal the JAX
package's, greedy ``generate`` is token-identical to the JAX package's on
the same f32 weights (from a bos prompt and from a seed prompt), sampled
rows are grammatical, and a generated piece round-trips through
detokenize and the MIDI codec."""

import numpy as np
import pytest

from midi_model_tpu.interop import params_from_state_dict as jax_params_from_sd
from midi_model_tpu.models import MIDIModelConfig as JaxConfig
from midi_model_tpu.sampling import build_mask_table as jax_build_mask_table
from midi_model_tpu.sampling import generate as jax_generate
from midi_model_tpu_torch.interop import params_from_state_dict, synthesize_state_dict
from midi_model_tpu_torch.models import MIDIModelConfig
from midi_model_tpu_torch.sampling import build_mask_table, generate

from _torch_helpers import TINY, layout, one_torch_thread  # noqa: F401 (autouse)


@pytest.fixture(scope="module")
def setup():
    jcfg = JaxConfig.get_config("v1", False, **TINY)
    cfg = MIDIModelConfig.get_config("v1", False, **TINY)
    sd = synthesize_state_dict(layout(cfg), 2)  # weights whose greedy rows run 24 events
    return jcfg, cfg, jax_params_from_sd(sd, jcfg), params_from_state_dict(sd, cfg, device="cpu")


def seed_prompt(tok):
    rows = [[tok.bos_id] + [tok.pad_id] * 7,
            tok.event2tokens(["set_tempo", 0, 0, 0, 120]),
            tok.event2tokens(["note", 0, 0, 0, 8, 0, 60, 90])]
    return np.asarray(rows, np.int64)


def test_v1_vocab_and_masks(setup):
    jcfg, cfg, _, _ = setup
    tok = cfg.tokenizer
    assert tok.vocab_size == 3239 == jcfg.tokenizer.vocab_size
    table, jtable = build_mask_table(tok), jax_build_mask_table(jcfg.tokenizer)
    assert table.n_events == 4
    allowed0 = set(np.nonzero(table.first)[0].tolist())
    assert allowed0 == set(tok.event_ids.values()) | {tok.eos_id}
    np.testing.assert_array_equal(table.first, jtable.first)
    np.testing.assert_array_equal(table.steps, jtable.steps)


@pytest.mark.parametrize("prompted", [False, True], ids=["bos", "seed_prompt"])
def test_v1_greedy_matches_jax(setup, prompted):
    jcfg, cfg, params, model = setup
    prompt = seed_prompt(cfg.tokenizer) if prompted else None
    kw = dict(prompt=prompt, batch_size=2, max_len=24, greedy=True)
    ours = generate(model, cfg, **kw)
    theirs = np.asarray(jax_generate(params, jcfg, **kw))
    assert ours.shape[1:] == (24, cfg.tokenizer.max_token_seq) and ours.shape[2] == 8
    np.testing.assert_array_equal(ours, theirs)


def test_v1_generation_grammatical(setup):
    _, cfg, _, model = setup
    tok = cfg.tokenizer
    out = generate(model, cfg, batch_size=2, max_len=12, seed=9)
    assert out.shape[2] == tok.max_token_seq == 8
    for b in range(out.shape[0]):
        for row in out[b, 1:]:
            row = row.tolist()
            if row[0] in (tok.eos_id, tok.pad_id):
                continue
            assert tok.tokens2event(row), row


def test_v1_roundtrip_through_detokenize(setup):
    _, cfg, _, model = setup
    tok = cfg.tokenizer
    out = generate(model, cfg, prompt=seed_prompt(tok), batch_size=1, max_len=16, seed=4)
    score = tok.detokenize([list(r) for r in out[0]])
    assert score[0] == 480 and len(score) > 1
    from midi_model_tpu_torch.midi import midi2score, score2midi

    rt = midi2score(score2midi(score))
    assert rt[0] == 480
