"""busy_mfu.gap: the model operations of the event rows decoded in the
window / (the device's busy time x the bf16 peak), in %."""

from bench_h100 import readings


def read(run):
    if not readings.is_serve(run) or run.trace is None:
        return None
    return readings.share(readings.decode_flops(run), run.trace.busy_s() * readings.PEAK)
