"""batcher.rows_per_prefill.ttfc: requests admitted per prefill forward,
the program's counters ``batcher.prefill_prompts`` /
``batcher.prefill_forwards``."""

from bench_h100 import program_spans, readings


def read(run):
    if not readings.is_serve(run):
        return None
    return program_spans.counter_ratio(run, "batcher.prefill_prompts",
                                       "batcher.prefill_forwards")
