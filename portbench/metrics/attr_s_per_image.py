"""Seconds of the benchmark's ``attr`` spans (around ``get_attribution``
or ``batch_attribute``, which return host numpy, so the device work is
done) in the window, over the images scored (host clock)."""


def read(ctx):
    s = ctx["spans"].seconds("attr", ctx["lo_ns"], ctx["hi_ns"])
    return s / ctx["images"] if ctx["images"] else None
