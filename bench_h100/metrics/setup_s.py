"""setup_s: seconds from the process's start to the window's start (imports,
weights, the build where it runs, warm-up, lead-in traffic)."""


def read(run):
    return run.setup_s
