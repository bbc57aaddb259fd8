"""ssm_step_roofline.events: the Mamba-2 state-update kernel's floor (the
architecture module's ``ssm_step_bytes`` for the deployment's slots, one
per ``ssm_step`` kernel the trace holds, over 3.35 TB/s) / those kernels'
device time, in %.  None where the trace holds no such kernel (a program
or an architecture without it)."""

from bench_h100 import readings, spec, work

KERNELS = ("ssm_step_kernel",)


def read(run):
    if not readings.is_serve(run) or run.trace is None:
        return None
    count = getattr(spec.architecture(run.config), "ssm_step_bytes", None)
    ops = [e - s for s, e, n, _ in run.trace.device if any(k in n for k in KERNELS)]
    if count is None or not ops:
        return None
    slots = run.cell.traffic["deployment"]["slots"]
    bound = len(ops) * count(run.config, slots) / work.HBM_BYTES_PER_S
    return readings.share(bound, sum(ops) / 1e9)
