"""Scored images (map and 10 scores done) a second over the window: all
the images completed over the seconds from the window's start to the end
of its last step (host clock)."""


def read(ctx):
    return ctx["images"] / ctx["window_s"]
