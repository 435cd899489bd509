"""The whole step's share of the cards' peak: the least seconds the
cell's algorithm needs for the images scored at the card's peaks (its
FLOPs counted from the configuration's published shapes, each part at
the peak of its precision, ``yardstick.least_s_per_image``) over the
cards times the window's seconds.  Read in the traced run."""
from portbench.yardstick import least_s_per_image


def read(ctx):
    cfg = ctx["cfg"]
    least = ctx["images"] * least_s_per_image(
        ctx["family"].macs(cfg), ctx["traffic"], cfg["img_hw"],
        cfg["precision"])
    return 100.0 * least / (ctx["cards"] * ctx["window_s"])
