"""mfu.train: 3 x the forward's model operations over the non-pad work of
the window's steps / (the window x the bf16 peak), in %."""

from bench_h100 import readings


def read(run):
    if not readings.is_train(run) or not run.steps:
        return None
    flops = 3.0 * sum(s[3] for s in run.steps)
    return readings.share(flops, (run.t1 - run.t0) * readings.PEAK)
