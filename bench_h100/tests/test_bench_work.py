"""The work counts at a small size, worked by hand."""

import pytest

from bench_h100 import work


def small():
    net = {"num_hidden_layers": 2, "num_attention_heads": 2, "hidden_size": 8,
           "intermediate_size": 16}
    tok = {"num_hidden_layers": 1, "num_attention_heads": 1, "hidden_size": 8,
           "intermediate_size": 4}
    return {"tokenizer": {"vocab_size": 10, "row": 3, "pad_id": 0},
            "net_config": net, "net_token_config": tok}


def test_layer_params_and_kv_row():
    ev, tok = work.dims(small())
    assert ev.layer_params == 4 * 8 * 8 + 3 * 8 * 16  # q, k, v, o + gate, up, down
    assert tok.layer_params == 4 * 64 + 3 * 8 * 4
    assert ev.kv_row_elems == 2 * 2 * 2 * 4


def test_event_step_flops():
    c = small()
    ev, tok = work.dims(c)
    row = (2 * tok.layer_params * 1 * 3 + 4 * 1 * 8 * (1 + 2 + 3) * 1 + 2 * 8 * 10 * 3)
    assert work.token_row_flops(c) == row
    assert work.event_step_flops(c, 5) == row + 2 * ev.layer_params * 2 + 4 * 2 * 4 * 6 * 2


def test_decode_bound_takes_the_larger():
    """Two rows delivered at contexts 5 and 7 over one dispatched chunk of 2
    event steps: weights twice, each row's K/V and its append in and out."""
    import numpy as np

    from bench_h100 import readings

    c = small()
    ev, _ = work.dims(c)

    class Rec:
        class session:
            prompt = np.zeros((5, 3))
        blocks = [(1.0, 0, 1, 1), (2.0, 2, 1, 1)]
        rows = [np.ones((1, 1, 3)), np.ones((1, 1, 3))]

    class Run:
        config, records, dispatches, chunk = c, [Rec()], [1.0], 2

        @staticmethod
        def in_window(t):
            return True

    assert readings.decoded_contexts(Run()) == [5, 7]
    n_bytes = 2 * work.weight_bytes(c) + 2 * ev.kv_row_elems * (5 + 7 + 4)
    flops = work.event_step_flops(c, 5) + work.event_step_flops(c, 7)
    assert readings.decode_bound_s(Run()) == pytest.approx(
        max(n_bytes / work.HBM_BYTES_PER_S, flops / work.PEAK_FLOPS["bfloat16"]))


def test_attention_counts():
    f, b = work.attention_fwd(2, 4, 2, 1, 8)
    assert f == 4 * 2 * 2 * 8 * (4 * 5 / 2)
    assert b == 2 * 2 * 4 * 8 * (2 * 2 + 2 * 1)
    fb, bb = work.attention_bwd(2, 4, 2, 1, 8)
    assert fb == 2.5 * f
    assert bb == 2 * 2 * 4 * 8 * (4 * 2 + 4 * 1) + 4 * 2 * 2 * 4


def test_train_forward_counts_non_pad_work():
    import numpy as np

    c = small()
    batch = np.zeros((1, 5, 3), np.int64)
    batch[0, :3, 0] = [1, 3, 4]  # three live events, then pad
    want = work.prefill_flops(c, 3) + 2 * work.token_row_flops(c)
    assert work.train_forward_flops(c, batch) == want
