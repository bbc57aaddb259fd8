"""train.device_ops_per_step.train: the device operations whose launch
lies inside the program's ``train.step`` spans that lie in the window,
over those steps."""

from bench_h100 import program_spans, readings


def read(run):
    if not readings.is_train(run):
        return None
    rec = program_spans.recorded(run)
    if rec is None:
        return None
    steps = program_spans.in_window(rec[0], "train.step", run.trace.window)
    return program_spans.ratio(program_spans.ops_launched_in(run.trace, steps), len(steps))
