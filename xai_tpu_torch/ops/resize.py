"""Resize ops matching the torchvision semantics the reference relies on.

Counterpart of ``xai_tpu/ops/resize.py``.

- ``resize_bilinear``: transforms.Resize(..., antialias=True) on tensors
  (evaluatePerturbation.py:92, 201): half-pixel centers, triangle-filter
  antialiasing on downscale, computed as ``jax.image.resize(method=
  "linear")`` computes it: one weight matrix an axis (the triangle kernel,
  widened by the scale on downscale, each output's weights normalized to
  sum to 1) and a contraction with each.  Where an output lies outside
  the input's first or last pixel centre its one weight is exactly 1, so
  the resized map has exact plateaus there, as xai_tpu's has; an
  interpolation that rounds them away (``F.interpolate``) leaves
  last-bit ramps, and the sanity driver's HOG bins the orientation of a
  zero gradient (0 degrees) and of a last-bit one (0 or 180) apart.
- ``resize_nearest_exact``: InterpolationMode.NEAREST_EXACT
  (evaluatePerturbation.py:95, 202): index = floor((i + 0.5) * scale),
  with explicit gathers so it is bit-exact.

Both resize the trailing two dims of ``[..., H, W]`` (``[H, W]``,
``[C, H, W]``, ``[B, C, H, W]``).
"""
from __future__ import annotations

import numpy as np
import torch

_EPS32 = float(np.finfo(np.float32).eps)


def _linear_weights(n_in: int, n_out: int, device) -> torch.Tensor:
    """``[n_in, n_out]`` float32 weights of the antialiased linear resize
    of one axis (jax.image's ``compute_weight_mat``)."""
    inv_scale = 1.0 / (n_out / n_in)
    kernel_scale = max(inv_scale, 1.0)
    sample = (torch.arange(n_out, dtype=torch.float32, device=device)
              + 0.5) * inv_scale - 0.5
    dist = (sample[None, :] - torch.arange(n_in, dtype=torch.float32,
                                           device=device)[:, None]).abs()
    w = torch.clamp(1.0 - dist / kernel_scale, min=0.0)
    total = w.sum(dim=0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * _EPS32,
                    w / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], w, 0.0)


def resize_bilinear(x: torch.Tensor, hw: tuple) -> torch.Tensor:
    h, w = hw
    if x.shape[-2] != h:
        wy = _linear_weights(x.shape[-2], h, x.device).to(x.dtype)
        x = torch.matmul(wy.T, x)
    if x.shape[-1] != w:
        wx = _linear_weights(x.shape[-1], w, x.device).to(x.dtype)
        x = torch.matmul(x, wx)
    return x


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
