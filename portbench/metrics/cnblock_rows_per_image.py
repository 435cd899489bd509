"""Pixels of the program's ConvNeXt blocks an image scored: the growth of
its ``cnblock_rows`` counter (``models/convnext.py CNBlock``: batch times
pixels at each call, the pixels of its 7x7 depthwise convolution and the
token rows of its LayerNorm and MLP) over the window's top-level spans,
over the images scored.  None as ``window_attn_rows_per_image`` is:
without the program's spans, or where no span carries the counter (a
program that lacks it, or a model without ConvNeXt blocks)."""
from portbench.metrics.window_attn_rows_per_image import per_image


def read(ctx):
    return per_image(ctx, "cnblock_rows")
