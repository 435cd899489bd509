"""Device seconds of the program's ``norm`` part spans an image scored
(``xai_tpu_torch/utils/trace.py part``; every LayerNorm, fused or not,
every FoldedBN, and R101's epilogue as ``bn_act`` or as separate ops):
their summed ``device_s`` over the window, over the images scored.  None
where no such span has ``device_s``: a program without part spans, or a
model without the kind."""
from portbench.metrics.parts_window_pct import per_image


def read(ctx):
    return per_image(ctx, "norm")
