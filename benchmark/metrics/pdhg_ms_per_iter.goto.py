"""Device milliseconds of the sparse PDHG warm start per iteration: the
program's span ``scx.pdhg`` (the whole ``pdhg_mcf_device`` call) between
its CUDA events over its counter ``pdhg.iters``, in the traced
stretch."""
from benchmark.harness.program_trace import span_per_count


def read(run):
    return span_per_count("scx.pdhg", "pdhg.iters", 1e3)
