"""The window's seconds over the exact vertices it returned."""


def read(run):
    return run.window.seconds / run.units if run.units else None
