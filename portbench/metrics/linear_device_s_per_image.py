"""Device seconds of the program's ``linear`` part spans an image scored
(``xai_tpu_torch/utils/trace.py part``; every ``nn.Linear`` and every
1x1 convolution run as a GEMM: qkv, the projections, the MLPs' linears,
ConvNeXt's ``pw1`` and ``pw2``, MaxViT's ``_pointwise``, the heads):
their summed ``device_s`` over the window, over the images scored.  None
where no such span has ``device_s``: a program without part spans, or a
model without the kind."""
from portbench.metrics.parts_window_pct import per_image


def read(ctx):
    return per_image(ctx, "linear")
