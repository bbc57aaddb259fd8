"""busy_mfu.ttfc: the model operations of the window's admissions (the event
net over each prompt's own rows) and of its decoded rows / (the device's
busy time x the bf16 peak), in %."""

from bench_h100 import readings


def read(run):
    if not readings.is_serve(run) or run.trace is None:
        return None
    flops = readings.prefill_flops(run) + readings.decode_flops(run)
    return readings.share(flops, run.trace.busy_s() * readings.PEAK)
