"""Input pixels of the program's MBConv calls an image scored: the growth
of its ``mbconv_rows`` counter (``models/maxvit.py``: batch times input
pixels at each call, the resolution of the expansion's convolution, BN
and GELU) over the window's top-level spans, over the images scored.
None as ``window_attn_rows_per_image`` is: without the program's spans,
or where no span carries the counter (a program that lacks it, or a
model without MBConv)."""
from portbench.metrics.window_attn_rows_per_image import per_image


def read(ctx):
    return per_image(ctx, "mbconv_rows")
