"""Device seconds of the program's ``conv`` part spans an image scored
(``xai_tpu_torch/utils/trace.py part``; every cuDNN convolution: R101's
and its downsampling, the stems, the patch embeddings, the 3x3 and 7x7
depthwise, ConvNeXt's 2x2 and 4x4): their summed ``device_s`` over the
window, over the images scored.  None where no such span has
``device_s``: a program without part spans, or a model without the kind."""
from portbench.metrics.parts_window_pct import per_image


def read(ctx):
    return per_image(ctx, "conv")
