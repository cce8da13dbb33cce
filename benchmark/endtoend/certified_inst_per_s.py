"""Instances returned as certified exact vertices in the window, over the
window's seconds (whole requests: the one in flight at the close runs to
its end and counts)."""


def read(run):
    return run.units / run.window.seconds
