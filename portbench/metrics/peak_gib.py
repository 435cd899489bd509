"""The largest ``torch.cuda.max_memory_allocated`` over the cell's
cards, reset at the window's start and read at its end, in GiB."""


def read(ctx):
    return ctx["peak_bytes"] / 2 ** 30 if ctx["peak_bytes"] else None
