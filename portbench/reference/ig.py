"""Integrated Gradients (Sundararajan et al. 2017) with a zero baseline,
as the surveyed driver runs it: ``steps`` images ``alpha * x`` with the
alphas of ``linspace(0, 1, steps)`` (both ends), the gradient of the
target's logit for each, their mean times the input, summed over the
channels, absolute.  One forward and backward an image, ``steps`` rows.
"""
from __future__ import annotations

import torch


def attribute(model, x: torch.Tensor, targets, cfg: dict, steps: int = 50
              ) -> torch.Tensor:
    """``model.forward``: ``[N, 3, H, W]`` -> logits.  x: ``[B, 3, H, W]``
    normalized; targets: ``B`` classes; ``steps``: the drivers' 50.
    Returns ``[B, H, W]`` maps."""
    alphas = torch.linspace(0.0, 1.0, steps, device=x.device)
    maps = []
    for xi, t in zip(x, targets):
        rows = (alphas.view(-1, 1, 1, 1) * xi).requires_grad_(True)
        with torch.enable_grad():
            score = model.forward(rows)[:, int(t)].sum()
            (grad,) = torch.autograd.grad(score, rows)
        maps.append((grad.mean(0) * xi).sum(0).abs())
    return torch.stack(maps)
