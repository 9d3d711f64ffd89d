"""Set-up: process start to the window's start, on the host clock
(interpreter, imports, the load generator's start, the server's load and
warm-up, the fronts, the cell's priming)."""


def read(run):
    return run.setup_s
