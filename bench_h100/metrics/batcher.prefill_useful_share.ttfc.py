"""batcher.prefill_useful_share.ttfc: the prompt rows of the admissions'
prefill forwards over the rows they ran (group x bucket), the program's
counters ``batcher.prefill_prompt_rows`` / ``batcher.prefill_bucket_rows``,
in %."""

from bench_h100 import program_spans, readings


def read(run):
    if not readings.is_serve(run):
        return None
    return program_spans.counter_ratio(run, "batcher.prefill_prompt_rows",
                                       "batcher.prefill_bucket_rows", 100.0)
