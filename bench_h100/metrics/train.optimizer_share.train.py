"""train.optimizer_share.train: the host time of the program's
``train.optimizer`` spans (the global norm, the update and its
application) over that of its ``train.step`` spans, those lying in the
window, in %."""

from bench_h100 import program_spans, readings


def read(run):
    if not readings.is_train(run):
        return None
    rec = program_spans.recorded(run)
    if rec is None:
        return None
    window = run.trace.window
    opt = program_spans.durations_ms(program_spans.in_window(rec[0], "train.optimizer", window))
    step = program_spans.durations_ms(program_spans.in_window(rec[0], "train.step", window))
    return program_spans.ratio(sum(opt), sum(step), 100.0)
