"""mfu.events: the model operations of the event rows delivered in the
window / (the window x the bf16 peak), in %."""

from bench_h100 import readings


def read(run):
    if not readings.is_serve(run):
        return None
    return readings.share(readings.decode_flops(run), (run.t1 - run.t0) * readings.PEAK)
