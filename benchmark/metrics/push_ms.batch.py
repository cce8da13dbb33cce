"""Mean device milliseconds of the push to feasibility
(``ops/tree.py::push_to_bfs``) per batch: the program's span
``scx.push`` between its CUDA events, over the calls of ``scx.route`` in
the traced stretch."""
from benchmark.harness.program_trace import span_per_request


def read(run):
    return span_per_request(["scx.push"], "scx.route", 1e3, "event")
