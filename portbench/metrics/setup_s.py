"""Seconds from the process's start to the window's start: imports, the
bundle's build, the weights made and loaded, the kernels' first build in
a fresh checkout, and one warm step of the cell's shapes (host clock)."""


def read(ctx):
    return ctx["setup_s"]
