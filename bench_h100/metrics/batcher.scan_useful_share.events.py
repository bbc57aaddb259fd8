"""batcher.scan_useful_share.events: the prompt rows among the rows the
admissions' Mamba-2 scans ran (whole chunks up to each prompt's length
within its bucket), the program's counters (``batcher.ssm_scan_rows`` -
``batcher.ssm_scan_pad_rows``) / ``batcher.ssm_scan_rows``, in %.  None
where the program keeps no such counter."""

from bench_h100 import program_spans, readings


def read(run):
    if not readings.is_serve(run):
        return None
    rec = program_spans.recorded(run)
    if rec is None:
        return None
    rows = rec[1].get("batcher.ssm_scan_rows", 0)
    if not rows:
        return None
    return 100.0 * (rows - rec[1].get("batcher.ssm_scan_pad_rows", 0)) / rows
