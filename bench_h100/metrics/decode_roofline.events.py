"""decode_roofline.events: a floor on the decoding's device time (``readings.
decode_bound_s``) / the device time of every operation launched inside the
benchmark's ranges around ``ContinuousBatcher.step`` (admissions that
``step`` runs included), in %."""

from bench_h100 import readings


def read(run):
    if not readings.is_serve(run) or run.trace is None:
        return None
    return readings.share(readings.decode_bound_s(run),
                          run.trace.device_s_in_ranges("bench.decode_step"))
