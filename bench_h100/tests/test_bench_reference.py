"""The plain reference against small cases worked by hand."""

import math

import numpy as np
import pytest
import torch

from bench_h100.reference.grammar import Grammar
from bench_h100.reference.model import MidiModel, Net, fp8_round
from bench_h100.tests.tiny import tiny_config


def net(hidden=4, heads=1, inter=2, layers=1, weights=None):
    cfg = {"num_hidden_layers": layers, "num_attention_heads": heads, "hidden_size": hidden,
           "intermediate_size": inter, "rms_norm_eps": 1e-6, "rope_theta": 10000.0}
    return Net("n", cfg, weights or {}, "f32")


def test_rms_norm_by_hand():
    n = net(weights={"n.w": torch.tensor([1.0, 2.0, 1.0, 0.5])})
    x = torch.tensor([[1.0, 2.0, 3.0, 4.0]])
    r = math.sqrt((1 + 4 + 9 + 16) / 4 + 1e-6)
    want = torch.tensor([[1 / r, 2 * 2 / r, 3 / r, 0.5 * 4 / r]])
    torch.testing.assert_close(n.norm(x, "w"), want)


def test_rotary_by_hand():
    """head_dim 4: inv_freq [1, 1/100]; at position p the pair (x_i, x_{i+2})
    turns by p * inv_freq_i (the rotate-half layout)."""
    n = net()
    cos, sin = n.rope(torch.tensor([0, 1, 3]))
    x = torch.tensor([1.0, 0.5, -2.0, 3.0]).expand(3, 4)
    got = n.rotate(x, cos, sin)
    for row, p in enumerate((0, 1, 3)):
        a0, a1 = p * 1.0, p / 100.0
        want = [1.0 * math.cos(a0) - (-2.0) * math.sin(a0),
                0.5 * math.cos(a1) - 3.0 * math.sin(a1),
                -2.0 * math.cos(a0) + 1.0 * math.sin(a0),
                3.0 * math.cos(a1) + 0.5 * math.sin(a1)]
        torch.testing.assert_close(got[row], torch.tensor(want))


def test_swiglu_layer_by_hand():
    """One layer whose attention adds nothing (o_proj zero): x + down(silu(
    gate h) * up h) with h the normed x, then the final norm."""
    d = 4
    w = {"n.layers.0.input_layernorm.weight": torch.ones(d),
         "n.layers.0.post_attention_layernorm.weight": torch.ones(d),
         "n.norm.weight": torch.ones(d)}
    for p in ("q", "k", "v"):
        w[f"n.layers.0.self_attn.{p}_proj.weight"] = torch.eye(d)
    w["n.layers.0.self_attn.o_proj.weight"] = torch.zeros(d, d)
    w["n.layers.0.mlp.gate_proj.weight"] = torch.tensor([[1.0, 0, 0, 0], [0, 1.0, 0, 0]])
    w["n.layers.0.mlp.up_proj.weight"] = torch.tensor([[0, 0, 1.0, 0], [0, 0, 0, 1.0]])
    w["n.layers.0.mlp.down_proj.weight"] = torch.tensor([[1.0, 0], [0, 1.0], [0, 0], [0, 0]])
    n = net(weights=w)
    x = torch.tensor([[[1.0, -1.0, 2.0, 0.5]]])
    r = math.sqrt((1 + 1 + 4 + 0.25) / 4 + 1e-6)
    h = [v / r for v in (1.0, -1.0, 2.0, 0.5)]

    def silu(v):
        return v / (1 + math.exp(-v))

    y = [1.0 + silu(h[0]) * h[2], -1.0 + silu(h[1]) * h[3], 2.0, 0.5]
    ry = math.sqrt(sum(v * v for v in y) / 4 + 1e-6)
    torch.testing.assert_close(n(x)[0, 0], torch.tensor([v / ry for v in y]))


def test_causal_attention_one_head():
    """Row 0 attends only itself; row 1 averages by softmax of its scores."""
    n = net()
    q = torch.tensor([[[[1.0, 0, 0, 0], [0, 2.0, 0, 0]]]])
    k = torch.tensor([[[[1.0, 0, 0, 0], [0, 1.0, 0, 0]]]])
    v = torch.tensor([[[[1.0, 2, 3, 4], [5.0, 6, 7, 8]]]])
    out = n.attention(q, k, v)[0]
    torch.testing.assert_close(out[0], v[0, 0, 0])
    s = torch.tensor([0.0, 2.0]) / 2.0  # scores over d**0.5 = 2
    p = torch.softmax(s, 0)
    torch.testing.assert_close(out[1], p[0] * v[0, 0, 0] + p[1] * v[0, 0, 1])


def test_event_embedding_is_the_rows_sum():
    cfg = tiny_config()
    from bench_h100 import weights

    state = weights.make(cfg, 3, torch.float32, "cpu")
    m = MidiModel(cfg, state)
    rows = torch.tensor([[[1, 0, 0, 0, 0, 0, 0, 0], [3, 200, 300, 400, 0, 0, 0, 0]]])
    emb = state["net.embed_tokens.weight"]
    got = m.w["net.embed_tokens.weight"][rows].sum(-2)
    torch.testing.assert_close(got[0, 1], emb[3] + emb[200] + emb[300] + emb[400] + 4 * emb[0])


def test_grammar_of_tokenizer_v2():
    g = Grammar(tiny_config()["tokenizer"])
    assert (g.vocab_size, g.row, g.first_event, g.n_events) == (3406, 8, 3, 6)
    lo, hi = g.param_range["time1"]
    row = np.array([[3, lo, 0, 0, 0, 0, 0, 0]])
    assert g.violations(row) == 6  # a note needs its other six parameters
    allow = g.allowed(row)
    assert allow[0, 0, 3:9].all() and not allow[0, 0, g.eos_id]
    assert allow[0, 1, lo:hi].all() and allow[0, 1].sum() == 128
    ban = g.allowed(row, disable_channels=[2, 9])
    c_lo, _ = g.param_range["channel"]
    assert not ban[0, 4, c_lo + 2] and ban[0, 4, c_lo + 3]


def test_fp8_round_keeps_representable_values():
    x = torch.tensor([[448.0, 1.0, 0.5, -2.0, 1.0625]])  # the row's max maps to 448
    got = fp8_round(x)
    torch.testing.assert_close(got[0, :4], x[0, :4])
    assert got[0, 4] in (1.0, 1.125)


@pytest.mark.parametrize("precision", ["f32", "fp8"])
def test_loss_is_mean_over_non_pad(precision):
    cfg = tiny_config()
    from bench_h100 import weights

    m = MidiModel(cfg, weights.make(cfg, 4, torch.float32, "cpu"), precision)
    batch = torch.randint(3, 3406, (2, 5, 8))
    batch[:, 3:] = 0
    loss = m.loss(batch)
    assert torch.isfinite(loss) and 7.0 < float(loss) < 9.5  # ~ln(3406) at init
