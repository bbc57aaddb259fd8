"""attention_roofline.train: the causal attention forward and backward
bound of the window's steps (each microbatch: the event net's layers at
[batch, events - 1, heads, head_dim], the token net's at [batch x (events
- 1), row, heads, head_dim]) / the device time of the attention kernels
(names below), in %."""

import sys

from bench_h100 import readings, work

KERNELS = ("fwd_wgmma_kernel", "fwd_tf32_kernel", "fwd_rows256_kernel", "delta_kernel",
           "dkdv_tc_kernel", "dq_tc_kernel", "dkdv_tf32_kernel", "dq_tf32_kernel",
           "dkdv_rows256_kernel", "dq_rows256_kernel", "flash_fwd", "flash_bwd", "fmha_",
           "efficient_attention", "attention_fwd", "attention_bwd")


def read(run):
    if not readings.is_train(run) or run.trace is None or not run.steps:
        return None
    mix, cfg = run.cell.traffic, run.config
    ev, tok = work.dims(cfg)
    b, s, t = mix["batch_size"], mix["max_len"] - 1, cfg["tokenizer"]["row"]
    per_mb = 0.0
    for d, batch, seq in ((ev, b, s), (tok, b * s, t)):
        f1, b1 = work.attention_fwd(batch, seq, d.heads, d.kv_heads, d.head_dim)
        f2, b2 = work.attention_bwd(batch, seq, d.heads, d.kv_heads, d.head_dim)
        per_mb += d.layers * (work.bound_s(f1, b1) + work.bound_s(f2, b2))
    bound = per_mb * mix["accum_steps"] * len(run.steps)
    time_s = run.trace.device_s(KERNELS)
    if not time_s:
        print("attention_roofline.train: no attention kernel matched", file=sys.stderr)
    return readings.share(bound, time_s)
