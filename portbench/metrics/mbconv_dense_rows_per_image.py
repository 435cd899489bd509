"""Input pixels of the program's MBConv calls an image scored whose input
was dense ``[B, H, W, C]`` memory: the growth of its ``mbconv_dense_rows``
counter (``models/maxvit.py``: batch times input pixels at each call
whose input is contiguous) over the window's top-level spans, over the
images scored; equal to ``mbconv_rows_per_image`` where every MBConv
input is dense.  None as ``window_attn_rows_per_image`` is: without the
program's spans, or where no span carries the counter (a program that
lacks it, or a model without MBConv)."""
from portbench.metrics.window_attn_rows_per_image import per_image


def read(ctx):
    return per_image(ctx, "mbconv_dense_rows")
