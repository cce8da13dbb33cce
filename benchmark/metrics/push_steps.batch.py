"""Mean host-driven steps of the push loop (``ops/tree.py::push_to_bfs``)
per batch: the program's counter ``push.steps`` inside ``scx.route``,
over its calls in the traced stretch."""
from benchmark.harness.program_trace import counter_per_request


def read(run):
    return counter_per_request("push.steps", "scx.route")
