"""The image stream: a pool of test images made from ``--seed``.

One general generator that every traffic mix's ``images`` block
parameterizes: ``pool`` distinct images, each a ``coarse_grid`` x
``coarse_grid`` random colour field upsampled bilinearly to the model's
size, plus uniform noise of amplitude ``noise``, clipped to [0, 1].  The
closed loop walks the pool in order and wraps around.  Every image costs
the program the same work whatever its pixels, so the seed changes which
images are scored and not how much work they are.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .weights import stream_seed


def image_pool(params: dict, img_hw: int, seed: int) -> np.ndarray:
    """``[pool, H, W, 3]`` float32 in [0, 1] (the drivers' ``trans_img``
    layout), made on the host."""
    rng = np.random.default_rng(stream_seed(seed, 1))
    n, g = params["pool"], params["coarse_grid"]
    coarse = torch.from_numpy(rng.random((n, 3, g, g), dtype=np.float32))
    field = F.interpolate(coarse, size=(img_hw, img_hw), mode="bilinear",
                          align_corners=False)
    noise = rng.random((n, 3, img_hw, img_hw), dtype=np.float32) - 0.5
    imgs = (field + params["noise"] * torch.from_numpy(noise)).clamp(0, 1)
    return np.ascontiguousarray(imgs.permute(0, 2, 3, 1).numpy())
