"""Time and profile the PyTorch port's decode loop on one CUDA card.

    python tools/profile_torch_decode.py [PACKAGE_ROOT] [TAG]

tv2o-medium, random bf16 weights, bs=32, eos disabled: two timed runs of
prefill + 256 events after a warm-up, then torch.profiler over 16 events
decoded after 64.  Prints the profiler's table by device time, then one
JSON line (events/s, device time and busy share per event, launches per
event, the top kernels).  PACKAGE_ROOT (default:
the repo) is the directory holding the ``midi_model_tpu_torch`` to time, so
two versions of the port can be compared in turns on one card.
"""

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
BATCH, EVENTS, PROFILE_EVENTS = 32, 256, 16


def main() -> int:
    package_root = sys.argv[1] if len(sys.argv) > 1 else str(ROOT)
    tag = sys.argv[2] if len(sys.argv) > 2 else "port"
    sys.path[:0] = [package_root, str(ROOT)]  # the port to time, then the repo

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from midi_model_tpu_torch.models import MIDIModelConfig
    from midi_model_tpu_torch.models.midinet import init_model
    from midi_model_tpu_torch.sampling import (build_mask_table, decode_events,
                                               mask_tensors, normalize_prompt,
                                               prefill)

    if not torch.cuda.is_available():
        print("profile_torch_decode.py: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    config = MIDIModelConfig.from_name("tv2o-medium")
    tok = config.tokenizer
    model = init_model(config, seed=0, dtype=torch.bfloat16, device=dev)
    prompt = normalize_prompt(tok, None, BATCH)
    masks = mask_tensors(build_mask_table(tok, disable_eos=True), dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(42)

    def run(n):
        state = prefill(model, config, prompt, 1 + EVENTS)
        state, _, _ = decode_events(model, config, state, masks, n, 1.0, 0.98,
                                    20, gen)
        return state

    run(8)  # warm-up
    torch.cuda.synchronize()
    rates = []
    for _ in range(2):
        t0 = time.perf_counter()
        run(EVENTS)
        torch.cuda.synchronize()
        rates.append(BATCH * EVENTS / (time.perf_counter() - t0))

    state = run(64)  # a mid-length cache
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        decode_events(model, config, state, masks, PROFILE_EVENTS, 1.0, 0.98,
                      20, gen)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    averages = prof.key_averages()
    kernels = sorted(((e.key, e.self_device_time_total, e.count)
                      for e in averages if e.device_type == DeviceType.CUDA),
                     key=lambda x: -x[1])
    device_us = sum(t for _, t, _ in kernels)
    print(averages.table(sort_by="self_device_time_total", row_limit=40))
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    n = PROFILE_EVENTS
    print(json.dumps({
        "tag": tag, "card": card, "events_per_s": rates,
        "profile_events": n,
        "profile_wall_ms_per_event": wall_us / n / 1e3,
        "device_ms_per_event": device_us / n / 1e3,
        "device_busy_share": device_us / wall_us,
        "device_launches_per_event": sum(c for _, _, c in kernels) / n,
        "top_kernels_ms_per_event": [(k[:60], t / n / 1e3, c // n)
                                     for k, t, c in kernels[:12]],
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
