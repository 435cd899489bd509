"""Query rows of the program's windowed attention under a shift mask an
image scored: the growth of its ``masked_window_rows`` counter (Swin's
shifted blocks) over the window's top-level spans, over the images
scored.  None as ``window_attn_rows_per_image`` is."""
from portbench.metrics.window_attn_rows_per_image import per_image


def read(ctx):
    return per_image(ctx, "masked_window_rows")
