"""The granite hybrid configuration (``configs/tv2o-granite-h-micro.json``)
and its architecture module (``reference/granite_hybrid.py``): the layout
and the counts pinned at the published widths, the seeded draw following
each tensor's rule, the cell found from data files alone, and the cell run
at a tiny size on the CPU with its readers."""

import copy
import hashlib
import json
import time

import numpy as np
import torch

from bench_h100 import spec, weights, work
from bench_h100.reference import granite_hybrid as gh
from bench_h100.tests.tiny import SERVE_LIMITS

NAME = "tv2o-granite-h-micro"
CELL = NAME + ".app_saturated"
# the published event net's keys (the catalog's config.json), as the file
# keeps them at its top level and in net_config; the two it changes
PUBLISHED = {"vocab_size": 100352, "max_position_embeddings": 131072}


def published() -> dict:
    return spec.load_json(spec.HERE / "configs" / f"{NAME}.json")


def tiny_config() -> dict:
    """The configuration at a size the CPU runs in seconds: 4 layers (one
    attention), hidden 64, 4 Mamba-2 heads x 16, state 16, chunk 8."""
    c = copy.deepcopy(published())
    c["net_config"].update(hidden_size=64, num_hidden_layers=4,
                           layer_types=["mamba", "attention", "mamba", "mamba"],
                           num_attention_heads=4, num_key_value_heads=2,
                           shared_intermediate_size=128, mamba_n_heads=4, mamba_d_head=16,
                           mamba_d_state=16, mamba_expand=1, mamba_chunk_size=8)
    c["net_token_config"].update(num_hidden_layers=1, num_attention_heads=1,
                                 num_key_value_heads=1, hidden_size=64, intermediate_size=32)
    c["n_embd"] = 64
    c["dtype"] = "float32"
    return c


def test_the_file_keeps_the_published_keys():
    """Every key of the published config at the file's top level and in its
    net_config, equal, the values as published but the two in ``reduced``
    (the benchmark's entry), whose published values the file keeps."""
    c = published()
    entry = next(e for e in spec.load_json(spec.ROOT / "BENCHMARK.json")["configs"]
                 if e["name"] == NAME)
    assert sorted(entry["reduced"]) == sorted(PUBLISHED) == sorted(c["published"])
    assert c["published"] == PUBLISHED
    net = c["net_config"]
    assert all(c[k] == v for k, v in net.items())
    assert (net["vocab_size"], net["max_position_embeddings"]) == (3406, 4096)
    assert net["model_type"] == "granitemoehybrid" and net["num_hidden_layers"] == 40
    assert [i for i, t in enumerate(net["layer_types"]) if t == "attention"] == [5, 15, 25, 35]
    assert (net["hidden_size"], net["mamba_n_heads"], net["mamba_d_head"],
            net["mamba_d_state"], net["shared_intermediate_size"]) == (2048, 64, 64, 128, 8192)
    assert c["net_token_config"]["hidden_size"] == c["n_embd"] == 2048


def test_layout_and_counts_are_pinned():
    """40 layers (36 Mamba-2, 4 GQA), 2.98 B parameters in the layers; the
    work counts at the published widths."""
    c = published()
    assert spec.architecture(c) is gh
    layout = gh.layout(c)
    assert len(layout) == 496
    in_layers = sum(int(np.prod(e[1])) for e in layout if e[0].startswith("net.layers."))
    assert in_layers == 2_985_873_152
    flat = [[e[0], list(e[1])] + ([list(e[2])] if len(e) > 2 else []) for e in layout]
    assert hashlib.sha256(json.dumps(flat).encode()).hexdigest() == (
        "cfa2395af466630c7fb9564bb49007761d465b13fc76ae87c1692e38cab0575e")
    ev, _ = work.dims(c)
    assert (ev.layers, ev.mamba_layers, ev.layer_elements) == (4, 36, in_layers)
    assert [work.event_step_flops(c, x) for x in (0, 511, 4095)] == [
        7568105472.0, 7584849920.0, 7702290432.0]
    assert [work.prefill_flops(c, x) for x in (1, 512, 4096)] == [
        6007628800.0, 3109709676544.0, 25185841315840.0]
    assert (work.weight_bytes(c), work.token_row_flops(c)) == (6161858048, 1521778688.0)
    # a slot's step: 2.42 GB / 32 of f32 state read and written, its conv
    # state, and its 4 layers' K/V rows
    state = 2 * (4 * 36 * 64 * 64 * 128 + 2 * 36 * 3 * 4352)
    kv = 2 * 2 * 4 * 8 * 64
    assert [work.cache_bytes(c, x, "bfloat16") for x in (0, 511, 4095)] == [
        state + kv * (x + 2) for x in (0, 511, 4095)]
    assert gh.ssm_step_bytes(c, 32) == 136747904.0
    assert [gh.ssm_scan_flops(c, r) for r in (1, 256, 257, 512)] == [
        38052864.0, 19668271104.0, 19744072704.0, 49000218624.0]
    assert [gh.ssm_scan_bytes(c, r) for r in (1, 256, 257, 512)] == [
        76409856.0, 309067776.0, 309980160.0, 542638080.0]


def test_weights_follow_the_layout_rules():
    """A seeded draw at the tiny size: matrices N(0, init_std), norm scales
    1, A_log in [0, ln 16], dt_bias in [-6.91, -2.25], D 1, the convolution
    in +-0.5; the names and shapes are the port's state dict."""
    from midi_model_tpu_torch.models.config import MIDIModelConfig
    from midi_model_tpu_torch.models.midinet import MIDINet

    c = tiny_config()
    state = weights.make(c, 2 ** 31 + 3, torch.float32, "cpu")
    assert sorted(state) == sorted(e[0] for e in gh.layout(c))
    model = MIDINet(MIDIModelConfig.from_dict(c), device="cpu")
    model.load_state_dict(state)  # strict: the same names and shapes
    a_log = torch.cat([v for n, v in state.items() if n.endswith("A_log")])
    dt_bias = torch.cat([v for n, v in state.items() if n.endswith("dt_bias")])
    conv = torch.cat([v.flatten() for n, v in state.items() if "conv1d" in n])
    assert 0.0 <= float(a_log.min()) and float(a_log.max()) <= np.log(16.0)
    assert -6.91 <= float(dt_bias.min()) and float(dt_bias.max()) <= -2.25
    assert -0.5 <= float(conv.min()) and float(conv.max()) <= 0.5 and float(conv.std()) > 0.2
    assert all(bool((v == 1).all()) for n, v in state.items()
               if n.endswith(".D") or n.endswith("norm.weight"))
    mats = torch.cat([v.flatten() for n, v in state.items() if v.ndim == 2])
    assert abs(float(mats.std()) - c["init_std"]) < 1e-3


def test_the_cell_comes_from_data_files():
    """``spec.find_cell`` finds the cell from its entries and files: the
    configuration, the existing ``app_saturated`` traffic, its limits, the
    architecture module the configuration names, and a reader for every
    metric it reports."""
    cell = spec.find_cell(CELL)
    assert cell.chips == 1 and cell.arch is gh and cell.traffic_name == "app_saturated"
    assert cell.traffic == spec.find_cell("tv2o-large.app_saturated").traffic
    assert set(cell.limits["limits"]) == {"logit_gap", "grammar_violations",
                                          "incomplete_requests"}
    assert [m["name"] for m in cell.end_to_end] == ["setup_s", "events_per_s"]
    names = [m["name"] for m in cell.per_layer]
    for name in ("ssm_step_roofline.events", "ssm_scan_roofline.events",
                 "batcher.scan_useful_share.events", "decode_roofline.events",
                 "device.idle_share.events"):
        assert name in names
    for m in cell.end_to_end + cell.per_layer:
        assert callable(spec.reader(m["name"]))


def test_the_cell_runs_at_a_tiny_size():
    """The cell on the CPU at a tiny size, traced: ``correct``, and the
    counter reader reads the scan's rows; the device readers find nothing
    to read on the CPU and leave their metrics out."""
    from bench_h100.run import run_cell

    cell = spec.find_cell(CELL)
    cell.config = tiny_config()
    t = cell.traffic
    t["deployment"] = {"slots": 4, "max_seq": 256, "chunk": 4, "variations": 2,
                       "kv_int8": False}
    t["prompt"] = {"dist": "log_uniform", "min": 4, "max": 40}
    t["generate"] = {"dist": "uniform", "min": 8, "max": 16}
    t["lead_in_s"] = 0.5
    t["knobs"]["rules"][-1].update(every=2, at=0)
    t["clients"], t["sessions_per_client"] = 2, 8
    t["check"]["sample_requests"] = 3
    cell.limits = {"limits": dict(SERVE_LIMITS)}
    torch.set_num_threads(2)
    result, check, _ = run_cell(cell, 2 ** 31 + 7, 2.0, True, torch.device("cpu"),
                                time.perf_counter())
    assert result["correct"], check
    useful = result["metrics"]["batcher.scan_useful_share.events"]["value"]
    assert 0.0 < useful <= 100.0
    assert "ssm_step_roofline.events" not in result["metrics"]
