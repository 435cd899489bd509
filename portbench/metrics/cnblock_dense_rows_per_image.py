"""Pixels of the program's ConvNeXt blocks an image scored whose input was
dense ``[B, H, W, C]`` memory: the growth of its ``cnblock_dense_rows``
counter (``models/convnext.py CNBlock``: batch times pixels at each call
whose input is contiguous) over the window's top-level spans, over the
images scored; equal to ``cnblock_rows_per_image`` where every block
input is dense.  None as ``window_attn_rows_per_image`` is: without the
program's spans, or where no span carries the counter (a program that
lacks it, or a model without ConvNeXt blocks)."""
from portbench.metrics.window_attn_rows_per_image import per_image


def read(ctx):
    return per_image(ctx, "cnblock_dense_rows")
