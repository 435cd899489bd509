"""Attribution-recalibration reference samplers
(util/attribution_methods/attribution_recalibration/saliency_methods/
{IG_SG, IG_Uniform}.py): expected-gradients-style IG with a bag of
references.  IG-SG draws Gaussian-noised copies of the input, IG-Uniform
uniform-random images; k interpolation steps per reference; the
attribution is the mean over (references x steps) of grad x (input - ref).

Counterpart of ``xai_tpu/methods/recalibration.py``.  The references are
drawn from the caller's ``torch.Generator``, or injected as ``refs=``
(the parity hook: JAX's draws cannot be reproduced by torch).
"""
from __future__ import annotations

import torch

from .gradient import _fit_chunk


def _expected_ig(bundle, x, refs, target: int, k: int, chunk: int):
    """x: ``[H, W, C]``; refs: ``[B, H, W, C]`` reference bag; k alphas in
    (0, 1]; the B*k gradients in chunks of ``chunk``."""
    b = refs.shape[0]
    alphas = (torch.arange(1, k + 1, device=x.device) / k).to(x.dtype) \
        .view(k, 1, 1, 1)
    pts = (refs[:, None] + alphas[None] * (x[None, None] - refs[:, None])) \
        .reshape((b * k,) + x.shape)
    deltas = (x[None, None] - refs[:, None]).expand((b, k) + x.shape) \
        .reshape((b * k,) + x.shape)
    grads = torch.cat([bundle.score_and_grad(
        pts[i:i + chunk].permute(0, 3, 1, 2).contiguous(), target)[0]
        for i in range(0, b * k, chunk)]).permute(0, 2, 3, 1)
    return (grads * deltas).mean(dim=0)


def ig_sg(bundle, x, target, generator=None, k: int = 10, bg_size: int = 10,
          sigma: float = 0.15, chunk: int = 10, refs=None):
    """IntGradSG: references = input + N(0, sigma * (max - min)) noise."""
    if refs is None:
        std = sigma * (x.max() - x.min())
        refs = x[None] + std * torch.randn((bg_size,) + x.shape,
                                           generator=generator,
                                           device=x.device)
    refs = torch.as_tensor(refs, dtype=x.dtype, device=x.device)
    return _expected_ig(bundle, x, refs, target, k,
                        _fit_chunk(k * refs.shape[0], chunk))


def ig_uniform(bundle, x, target, generator=None, k: int = 10,
               bg_size: int = 10, chunk: int = 10, low: float = -1.0,
               high: float = 1.0, refs=None):
    """IntGradUniform: references = uniform-random (normalized) images."""
    if refs is None:
        refs = torch.rand((bg_size,) + x.shape, generator=generator,
                          device=x.device, dtype=x.dtype) \
            * (high - low) + low
    refs = torch.as_tensor(refs, dtype=x.dtype, device=x.device)
    return _expected_ig(bundle, x, refs, target, k,
                        _fit_chunk(k * refs.shape[0], chunk))
