"""A cell of the benchmark cut to a size the CPU runs in seconds: the
configuration's widths and depth and the mix's lengths made small, the
deployment a few slots, the limits set for this size."""

import copy
import time

import torch

from bench_h100 import spec

# readings of sound runs at this size: f32 serving reads a gap of 0; bf16
# training ~1e-5 (loss), ~1.5e-3 (gradient norms), ~5e-4 (change norms)
SERVE_LIMITS = {"logit_gap": 1e-3, "grammar_violations": 0, "incomplete_requests": 0}
TRAIN_LIMITS = {"loss_rel": 2e-4, "grad_norm_gap": 6e-3, "change_norm_gap": 3e-3,
                "nonfinite_losses": 0}


def tiny_config(name: str = "tv2o-medium") -> dict:
    c = copy.deepcopy(spec.load_json(spec.HERE / "configs" / f"{name}.json"))
    c["net_config"].update(num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=4,
                           hidden_size=64, intermediate_size=128)
    c["net_token_config"].update(num_hidden_layers=1, num_attention_heads=1,
                                 num_key_value_heads=1, hidden_size=64, intermediate_size=32)
    c["n_embd"] = 64
    c["dtype"] = "float32"
    return c


def tiny_cell(name: str) -> spec.Cell:
    cell = spec.find_cell(name)
    cell.config = tiny_config(cell.config_name)
    t = cell.traffic
    if t["kind"] == "serve":
        t["deployment"] = {"slots": 4, "max_seq": 256, "chunk": 4, "variations": 2,
                           "kv_int8": t["deployment"].get("kv_int8", False)}
        t["prompt"] = {"dist": "log_uniform", "min": 4, "max": 40}
        t["generate"] = {"dist": "uniform", "min": 8, "max": 16}
        t["lead_in_s"] = 0.5
        t["knobs"]["rules"][-1]["every"] = 2  # more greedy sessions to compare
        t["knobs"]["rules"][-1]["at"] = 0
        if t["loop"] == "open":
            t["rate_sessions_per_s"] = 2.0
        else:
            t["clients"], t["sessions_per_client"] = 2, 8
        t["check"]["sample_requests"] = 3
        cell.limits = {"limits": dict(SERVE_LIMITS)}
    else:
        t["max_len"] = 48
        t["file_events"] = {"dist": "log_uniform", "min": 16, "max": 128}
        cell.limits = {"limits": dict(TRAIN_LIMITS)}
    return cell


def run(name: str, seconds: float = 2.0, seed: int = 2 ** 31 + 7, fault=None, trace=False):
    from bench_h100.run import run_cell

    torch.set_num_threads(2)
    result, check, _ = run_cell(tiny_cell(name), seed, seconds, trace, torch.device("cpu"),
                                time.perf_counter(), fault=fault)
    return result, check
