"""The share of the window in which no operation ran on a card (the
union of the traced kernel, copy and set intervals), averaged over the
cell's cards.  None without a trace."""


def read(ctx):
    if not ctx["traced"]:
        return None
    busy = sum(ctx["busy_s"]) / ctx["cards"]
    return 100.0 * (1.0 - busy / ctx["window_s"])
