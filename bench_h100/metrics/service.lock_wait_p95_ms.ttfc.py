"""service.lock_wait_p95_ms.ttfc: the 95th percentile of the program's
``service.lock_wait`` spans (a submission's wait for the
``BatcherService`` lock, from the call to the lock taken) that lie in the
window, in ms."""

from bench_h100 import program_spans, readings


def read(run):
    if not readings.is_serve(run):
        return None
    return program_spans.p95_ms(run, "service.lock_wait")
