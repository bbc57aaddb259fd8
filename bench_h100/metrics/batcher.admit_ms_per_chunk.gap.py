"""batcher.admit_ms_per_chunk.gap: the summed durations of the program's
``batcher.admit`` spans (one prefill forward each, on any thread) over the
chunks dispatched (``batcher.dispatch`` spans), both lying in the window,
in ms per chunk."""

from bench_h100 import program_spans, readings


def read(run):
    if not readings.is_serve(run):
        return None
    rec = program_spans.recorded(run)
    if rec is None:
        return None
    window = run.trace.window
    admits = program_spans.in_window(rec[0], "batcher.admit", window)
    chunks = program_spans.in_window(rec[0], "batcher.dispatch", window)
    return program_spans.ratio(sum(program_spans.durations_ms(admits)), len(chunks))
