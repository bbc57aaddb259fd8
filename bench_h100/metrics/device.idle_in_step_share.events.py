"""device.idle_in_step_share.events: the device-idle time of the window
(no operation running) while a program ``batcher.step`` span is open, over
the window, in %; a step open across an edge of the window counts with
its part inside.  The rest of ``device.idle_share.events`` falls outside
``step``."""

from bench_h100 import program_spans, readings


def read(run):
    if not readings.is_serve(run):
        return None
    rec = program_spans.recorded(run)
    if rec is None:
        return None
    steps = [s for s in rec[0] if s.name == "batcher.step"]
    lo, hi = run.trace.window
    return program_spans.ratio(program_spans.idle_within_ns(run.trace, steps), hi - lo, 100.0)
