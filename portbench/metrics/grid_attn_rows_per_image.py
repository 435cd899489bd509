"""Query rows of the program's grid attention an image scored: the growth
of its ``grid_attn_rows`` counter (``models/maxvit.py AttnLayer``: groups
times tokens a group at each grid call) over the window's top-level
spans, over the images scored.  None as ``window_attn_rows_per_image``
is: without the program's spans, or where no span carries the counter (a
program that lacks it, or a model without grid attention)."""
from portbench.metrics.window_attn_rows_per_image import per_image


def read(ctx):
    return per_image(ctx, "grid_attn_rows")
