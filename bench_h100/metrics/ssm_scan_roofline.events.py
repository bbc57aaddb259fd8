"""ssm_scan_roofline.events: the window's admissions' Mamba-2 scans at
their floor (the larger of the architecture module's ``ssm_scan_bytes``
over 3.35 TB/s and ``ssm_scan_flops`` over 989 TFLOP/s, summed over the
admitted prompts' lengths) / the device time of the ``ssm_scan`` kernels,
in %.  None where the trace holds no such kernel."""

from bench_h100 import readings, spec, work

KERNELS = ("ssm_scan_kernel",)


def read(run):
    if not readings.is_serve(run) or run.trace is None:
        return None
    arch = spec.architecture(run.config)
    flops_of = getattr(arch, "ssm_scan_flops", None)
    bytes_of = getattr(arch, "ssm_scan_bytes", None)
    time_s = run.trace.device_s(KERNELS)
    if flops_of is None or bytes_of is None or not time_s:
        return None
    lens = [n for _, _, group in readings.admissions_in_window(run) for n in group]
    flops = sum(flops_of(run.config, n) for n in lens)
    n_bytes = sum(bytes_of(run.config, n) for n in lens)
    return readings.share(work.bound_s(flops, n_bytes), time_s)
