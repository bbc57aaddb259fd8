"""attention_roofline.ttfc: the causal attention forward's bound at the
window's admission shapes (each admission: the event net's layers at
[group, bucket, heads, head_dim]) / the device time of the attention
kernels (names below), in %."""

import sys

from bench_h100 import readings, work

KERNELS = ("fwd_wgmma_kernel", "fwd_tf32_kernel", "fwd_rows256_kernel",
           "flash_fwd", "fmha_", "efficient_attention_forward", "attention_fwd")


def read(run):
    if not readings.is_serve(run) or run.trace is None:
        return None
    ev, _ = work.dims(run.config)
    bound = 0.0
    for _, bucket, lens in readings.admissions_in_window(run):
        flops, n_bytes = work.attention_fwd(len(lens), bucket, ev.heads, ev.kv_heads, ev.head_dim)
        bound += ev.layers * work.bound_s(flops, n_bytes)
    time_s = run.trace.device_s(KERNELS)
    if bound and not time_s:
        print("attention_roofline.ttfc: admissions but no attention kernel matched",
              file=sys.stderr)
    return readings.share(bound, time_s)
