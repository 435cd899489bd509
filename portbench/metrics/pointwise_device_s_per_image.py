"""Device seconds of the program's ``pointwise`` part spans an image scored
(``xai_tpu_torch/utils/trace.py part``; GELU, squeeze-excite, the layer
scale, the residual adds, the pools and the final mean): their summed
``device_s`` over the window, over the images scored.  None where no
such span has ``device_s``: a program without part spans, or a model
without the kind."""
from portbench.metrics.parts_window_pct import per_image


def read(ctx):
    return per_image(ctx, "pointwise")
