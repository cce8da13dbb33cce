"""Seconds from the process's start to the window's start: the
interpreter, the imports, the card's first use, the pool's generation,
the kernel library's build or load, and the warm-up."""


def read(run):
    return run.setup_s
