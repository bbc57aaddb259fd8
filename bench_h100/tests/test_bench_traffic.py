"""The traffic generator: one seed gives one schedule, every seed the same
sizes in another order, and the sizes follow their files."""

import math

import numpy as np
import pytest

from bench_h100 import spec, traffic
from bench_h100.reference.grammar import Grammar

TOK = spec.load_json(spec.HERE / "configs" / "tv2o-medium.json")["tokenizer"]


def mix(name):
    return spec.load_json(spec.HERE / "traffic" / f"{name}.json")


@pytest.mark.parametrize("name", ["app_steady", "app_prompt", "app_saturated"])
def test_same_seed_same_schedule(name):
    a = traffic.sessions(mix(name), TOK, 2 ** 31 + 11, 40)
    b = traffic.sessions(mix(name), TOK, 2 ** 31 + 11, 40)
    for x, y in zip(a, b):
        assert (x.due, x.gen_events, x.knobs, x.disable_channels, x.seed) == (
            y.due, y.gen_events, y.knobs, y.disable_channels, y.seed)
        np.testing.assert_array_equal(x.prompt, y.prompt)


@pytest.mark.parametrize("name", ["app_steady", "app_prompt"])
def test_every_seed_offers_the_same_work(name):
    m = mix(name)
    a = traffic.sessions(m, TOK, 5, 60)
    b = traffic.sessions(m, TOK, 6, 60)
    assert sorted(s.gen_events for s in a) == sorted(s.gen_events for s in b)
    assert sorted(len(s.prompt) for s in a) == sorted(len(s.prompt) for s in b)
    assert [s.gen_events for s in a] != [s.gen_events for s in b]
    # the same stratified gaps, reordered (one of them lies before the first arrival)
    gaps_a = set(np.round(np.diff([s.due for s in a]), 9))
    gaps_b = set(np.round(np.diff([s.due for s in b]), 9))
    assert len(gaps_a & gaps_b) >= len(a) - 2


def test_lengths_follow_their_files():
    m = mix("app_steady")
    s = traffic.sessions(m, TOK, 9, 400)
    gens = np.array([x.gen_events for x in s])
    assert gens.min() >= 256 and gens.max() <= 1024
    assert abs(np.mean(gens) - 640) < 5  # uniform 256-1024
    plens = np.array([len(x.prompt) for x in s])
    scratch = plens == 1
    assert abs(scratch.mean() - m["scratch_share"]) < 0.01
    rest = plens[~scratch]
    assert rest.min() >= 16 and rest.max() <= 512
    assert abs(np.median(rest) - math.sqrt(16 * 513)) / math.sqrt(16 * 513) < 0.05  # log-uniform
    due = np.array([x.due for x in s])
    assert abs((due[-1] / (len(due) - 1)) * m["rate_sessions_per_s"] - 1) < 0.05
    for x in s[:20]:
        assert x.prompt[0, 0] == TOK["bos_id"] and (x.prompt[0, 1:] == TOK["pad_id"]).all()


def test_knob_rules():
    m = mix("app_steady")
    s = traffic.sessions(m, TOK, 1, 30)
    assert s[1].knobs == {"temp": 0.9, "top_p": 0.9, "top_k": 8}
    assert s[3].greedy and s[9].greedy and not s[0].greedy
    assert s[2].disable_channels == [2, 9] and s[7].disable_channels == [2, 9]
    assert s[0].knobs == {"temp": 1.0, "top_p": 0.94, "top_k": 20}


def test_training_rows_obey_the_grammar():
    m = mix("train")
    feed = traffic.RowFeed(m, TOK, 2 ** 31 + 3)
    g = Grammar(TOK)
    for _ in range(3):
        b = feed.batch()
        assert b.shape == (2, 2, 2048, 8)
        for row in b.reshape(-1, 2048, 8):
            live = row[row[:, 0] != TOK["pad_id"]]
            events = live[(live[:, 0] != TOK["bos_id"]) & (live[:, 0] != TOK["eos_id"])]
            assert g.violations(events) == 0
            n = len(live)
            assert (row[n:] == TOK["pad_id"]).all()  # padding after the file
    again = traffic.RowFeed(m, TOK, 2 ** 31 + 3).batch()
    np.testing.assert_array_equal(again, traffic.RowFeed(m, TOK, 2 ** 31 + 3).batch())
    lens = traffic.quantiles(m["file_events"], 4096, np.random.default_rng(0))
    assert lens.min() >= 512 and lens.max() <= 8192
