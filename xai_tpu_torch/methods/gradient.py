"""Gradient-path attributions: grad, input×grad, IG, LIG.

Counterpart of ``xai_tpu/methods/gradient.py`` (reference:
util/attribution_methods/saliencyMethods.py).  IG runs one chunked
forward + backward sweep over the interpolation images; the LIG cutoff is
an argmax over the logit trace.

All functions take a ModelBundle and a normalized ``[H, W, C]`` input on
the model's device and return the per-channel attribution ``[H, W, C]``;
reduce with :func:`to_saliency`.  The input is transposed to NCHW once on
entry and the result back once on exit.  Gradients are taken with respect
to the input only (the bundle's parameters are frozen).
"""
from __future__ import annotations

import numpy as np
import torch


def to_saliency(attr: torch.Tensor) -> np.ndarray:
    """[H, W, C] signed attribution -> [H, W] |sum over channels|."""
    return attr.sum(dim=-1).abs().cpu().numpy()


def _grads_and_logits(bundle, images: torch.Tensor, target: int,
                      chunk: int):
    """images: [S, C, H, W] -> (grads [S, C, H, W], logits [S]), one
    batched forward + backward per ``chunk`` images
    (saliencyMethods.py:40-46 / 209-215)."""
    grads, logits = [], []
    for xb in images.split(chunk):
        g, s = bundle.score_and_grad(xb, target)
        grads.append(g)
        logits.append(s)
    return torch.cat(grads), torch.cat(logits)


def _unit_linspace(steps: int, dtype, device) -> torch.Tensor:
    """``jnp.linspace(0, 1, steps)`` with xai_tpu's values: k * (1/(steps-1))
    in float32, endpoint exactly 1.  ``torch.linspace`` rounds some steps
    one ulp apart, which a non-zero baseline's path amplifies past
    float32 parity."""
    if steps == 1:
        return torch.zeros(1, dtype=dtype, device=device)
    a = torch.arange(steps, dtype=dtype, device=device) * (1.0 / (steps - 1))
    a[-1] = 1.0
    return a


def grad(bundle, x: torch.Tensor, target: int) -> torch.Tensor:
    """d logit[target] / d input (saliencyMethods.py:7-11)."""
    g, _ = bundle.score_and_grad(x.permute(2, 0, 1)[None], target)
    return g[0].permute(1, 2, 0)


def inp_x_grad(bundle, x: torch.Tensor, target: int) -> torch.Tensor:
    return x * grad(bundle, x, target)


def ig(bundle, x: torch.Tensor, target: int, steps: int = 50,
       alpha_star: float = 1.0, baseline=0.0, chunk: int = None
       ) -> torch.Tensor:
    """Integrated Gradients; ``alpha_star < 1`` gives LIG (LeftIG): truncate
    the Riemann sum at the first step whose logit exceeds
    alpha_star * max_logit (saliencyMethods.py:48-67)."""
    chunk = chunk or min(bundle.meta.batch_size, steps)
    while steps % chunk:
        chunk -= 1
    xc = x.permute(2, 0, 1)
    baseline = torch.as_tensor(baseline, dtype=x.dtype, device=x.device
                               ).expand_as(x).permute(2, 0, 1)
    diff = xc - baseline
    alphas = _unit_linspace(steps, x.dtype, x.device).view(steps, 1, 1, 1)
    # one fused multiply-add per element, as XLA computes it: a separate
    # multiply and add round twice, and a one-ulp shift of an image can
    # cross a ReLU kink when the baseline is not zero
    images = torch.addcmul(baseline[None], alphas, diff[None])
    grads, logits = _grads_and_logits(bundle, images, target, chunk)
    if alpha_star >= 1.0:
        mean_grads = grads.mean(dim=0)
    else:
        above = logits > logits.max() * alpha_star
        # first step above the cutoff; 1 when none is (argmax of all-False
        # is 0, and a cutoff of 0 steps is clamped to 1)
        cutoff_step = int(torch.argmax(above.to(torch.uint8))) \
            if bool(above.any()) else 1
        cutoff_step = max(cutoff_step, 1)
        mean_grads = grads[:cutoff_step].sum(dim=0) / cutoff_step
    return (mean_grads * diff).permute(1, 2, 0)


def lig(bundle, x: torch.Tensor, target: int, steps: int = 50,
        baseline=0.0, alpha_star: float = 0.9, chunk: int = None
        ) -> torch.Tensor:
    return ig(bundle, x, target, steps, alpha_star, baseline, chunk)
