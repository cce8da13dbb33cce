"""K2's pivots per instance: the program's counter ``k2.pivots`` in
``scx.route`` over the traced stretch's batches and their instances."""
from benchmark.harness.k2_trace import pivots_per_instance


def read(run):
    return pivots_per_instance(run)
