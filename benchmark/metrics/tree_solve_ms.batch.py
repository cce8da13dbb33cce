"""Mean device milliseconds of the spanning-tree flow solve
(``ops/tree.py::bipartite_tree_solve``) per batch: the program's span
``scx.tree_solve`` between its CUDA events, over the calls of
``scx.route`` in the traced stretch."""
from benchmark.harness.program_trace import span_per_request


def read(run):
    return span_per_request(["scx.tree_solve"], "scx.route", 1e3, "event")
