"""PGD adversarial attack helper (MASTestFunctions.py:34-53): iterated FGSM
on cross-entropy with an epsilon ball around the original image, clamped to
[0, 1].  Counterpart of ``xai_tpu/methods/adversarial.py``; the reference
uses it as a robustness utility alongside the metric battery."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def pgd_attack(bundle, images: torch.Tensor, labels, eps: float = 0.3,
               iters: int = 10, alpha: float = 2 / 255) -> torch.Tensor:
    """images: [B, H, W, C] in [0, 1]; labels: [B] int. Returns adversarial
    images, [B, H, W, C]."""
    orig = images.permute(0, 3, 1, 2)
    labels = torch.as_tensor(labels, dtype=torch.int64, device=orig.device)
    x = orig
    for _ in range(iters):
        xg = x.detach().requires_grad_(True)
        with torch.enable_grad():
            ce = F.cross_entropy(bundle.apply(xg.to(bundle.dtype)).float(),
                                 labels)
            (g,) = torch.autograd.grad(ce, xg)
        eta = torch.clamp(x + alpha * torch.sign(g) - orig, -eps, eps)
        x = torch.clamp(orig + eta, 0.0, 1.0)
    return x.permute(0, 2, 3, 1)
