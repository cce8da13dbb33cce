"""K2's (the pivot-loop kernel's) device milliseconds per launch in the
traced stretch, by kernel name."""
KERNEL = "mega_kernel"


def read(run):
    if run.trace is None:
        return None
    s = run.trace.per_launch_s(KERNEL)
    return None if s is None else s * 1e3
