"""Attention rollout (Abnar and Zuidema 2020) with residual modelling, as
the surveyed ViT explainer runs it: each block's attention averaged over
heads, plus the identity, rows normalized to sum 1, multiplied from the
first block up; the CLS row over the patches as a grid, upsampled
bilinearly to the image (torchvision's ``Resize``), absolute.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def attribute(model, x: torch.Tensor, targets, cfg: dict) -> torch.Tensor:
    """``model.forward(x, attn_maps=True)``: ``[N, 3, H, W]`` -> (logits,
    head-mean attention ``[L, N, T, T]``).  Returns ``[B, H, W]`` maps
    (targets unused: the rollout does not read the class)."""
    img_hw = cfg["img_hw"]
    with torch.no_grad():
        _, maps = model.forward(x, attn_maps=True)
    t = maps.shape[-1]
    aug = maps + torch.eye(t, device=x.device)
    aug = aug / aug.sum(dim=-1, keepdim=True)
    joint = aug[0]
    for layer in aug[1:]:
        joint = layer @ joint
    p = int(round((t - 1) ** 0.5))
    grid = joint[:, 0, 1:].reshape(-1, 1, p, p)
    up = F.interpolate(grid, size=(img_hw, img_hw), mode="bilinear",
                       align_corners=False, antialias=True)
    return up[:, 0].abs()
