"""Seconds of the benchmark's ``battery`` spans (around ``run_battery``
or ``sharded_battery_scores``, which return host scores) in the window,
over the images scored (host clock)."""


def read(ctx):
    s = ctx["spans"].seconds("battery", ctx["lo_ns"], ctx["hi_ns"])
    return s / ctx["images"] if ctx["images"] else None
