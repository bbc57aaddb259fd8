"""train_tokens_per_s: non-pad target tokens of the steps completed in the
window / the time from the window's start to the last step's end."""

from bench_h100 import readings


def read(run):
    if not readings.is_train(run) or not run.steps:
        return None
    return sum(s[1] for s in run.steps) / (run.t1 - run.t0)
