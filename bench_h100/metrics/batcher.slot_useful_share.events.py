"""batcher.slot_useful_share.events: the event rows kept for their
requests over the slot steps dispatched (slots x chunk length a chunk),
the program's counters ``batcher.rows_delivered`` /
``batcher.slot_steps``, in %."""

from bench_h100 import program_spans, readings


def read(run):
    if not readings.is_serve(run):
        return None
    return program_spans.counter_ratio(run, "batcher.rows_delivered", "batcher.slot_steps",
                                       100.0)
