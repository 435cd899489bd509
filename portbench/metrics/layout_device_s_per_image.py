"""Device seconds of the program's ``layout`` part spans an image scored
(``xai_tpu_torch/utils/trace.py part``; reordering outside the
attention: ``torch.roll``, the window and grid partitions and reverses,
the stems' NHWC copies, MaxViT's shortcut copies, Swin's patch merging
gather): their summed ``device_s`` over the window, over the images
scored.  None where no such span has ``device_s``: a program without
part spans, or a model without the kind."""
from portbench.metrics.parts_window_pct import per_image


def read(ctx):
    return per_image(ctx, "layout")
