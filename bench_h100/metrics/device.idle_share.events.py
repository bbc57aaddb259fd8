"""device.idle_share.events: (the traced window - the union of the device's
operation intervals in it) / the window, in %."""

from bench_h100 import readings


def read(run):
    if not readings.is_serve(run) or run.trace is None:
        return None
    w = run.trace.window_s
    return 100.0 * (w - run.trace.busy_s()) / w
