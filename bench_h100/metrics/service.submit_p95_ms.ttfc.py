"""service.submit_p95_ms.ttfc: the 95th percentile of the wall time of the
``BatcherService.submit_group`` call (the service lock's wait and the
session's admissions that run inside it), by the benchmark's clock, over
the sessions due in the window."""

from bench_h100 import common, readings


def read(run):
    if not readings.is_serve(run):
        return None
    v = common.quantile([r.submit_s for r in run.measured() if r.submit_s is not None], 0.95)
    return None if v is None else v * 1e3
