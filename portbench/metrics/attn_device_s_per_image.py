"""Device seconds of the program's ``attn`` part spans an image scored
(``xai_tpu_torch/utils/trace.py part``; the attention between qkv and
the projection: the scores, the scale, the relative bias, the shift
mask, softmax, the product with the values and the head transposes):
their summed ``device_s`` over the window, over the images scored.  None
where no such span has ``device_s``: a program without part spans, or a
model without the kind."""
from portbench.metrics.parts_window_pct import per_image


def read(ctx):
    return per_image(ctx, "attn")
