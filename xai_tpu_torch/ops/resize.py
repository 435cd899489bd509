"""Resize ops matching the torchvision semantics the reference relies on.

Counterpart of ``xai_tpu/ops/resize.py``.

- ``resize_bilinear``: transforms.Resize(..., antialias=True) on tensors
  (evaluatePerturbation.py:92, 201): half-pixel centers, triangle-filter
  antialiasing on downscale, as ``jax.image.resize(method="linear")``.
- ``resize_nearest_exact``: InterpolationMode.NEAREST_EXACT
  (evaluatePerturbation.py:95, 202): index = floor((i + 0.5) * scale),
  with explicit gathers so it is bit-exact.

Both resize the trailing two dims of ``[..., H, W]`` (``[H, W]``,
``[C, H, W]``, ``[B, C, H, W]``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def resize_bilinear(x: torch.Tensor, hw: tuple) -> torch.Tensor:
    h, w = hw
    lead = x.shape[:-2]
    planes = x.reshape((-1, 1) + x.shape[-2:])
    out = F.interpolate(planes, size=(h, w), mode="bilinear",
                        align_corners=False,
                        antialias=h < x.shape[-2] or w < x.shape[-1])
    return out.reshape(lead + (h, w))


def _nearest_index(n_out: int, n_in: int, device) -> torch.Tensor:
    # float32, as xai_tpu's (arange + 0.5) * (H / h)
    i = (torch.arange(n_out, dtype=torch.float32, device=device) + 0.5) \
        * (n_in / n_out)
    return torch.floor(i).to(torch.int64).clamp(0, n_in - 1)


def resize_nearest_exact(x: torch.Tensor, hw: tuple) -> torch.Tensor:
    rows = _nearest_index(hw[0], x.shape[-2], x.device)
    cols = _nearest_index(hw[1], x.shape[-1], x.device)
    return x[..., rows, :][..., cols]


def upsample_patch_map(patch_map: torch.Tensor, img_hw: int) -> torch.Tensor:
    """[P, P] patch-level map -> [img_hw, img_hw] by bilinear upsample — the
    reference's ``resize(saliency_map)`` on 14x14/7x7 ViT maps."""
    return resize_bilinear(patch_map, (img_hw, img_hw))
