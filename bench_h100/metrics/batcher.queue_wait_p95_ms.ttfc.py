"""batcher.queue_wait_p95_ms.ttfc: the 95th percentile of the program's
``batcher.queued`` spans (a request's enqueue in ``ContinuousBatcher.
submit`` to the start of its group's prefill) that lie in the window, in
ms."""

from bench_h100 import program_spans, readings


def read(run):
    if not readings.is_serve(run):
        return None
    return program_spans.p95_ms(run, "batcher.queued")
