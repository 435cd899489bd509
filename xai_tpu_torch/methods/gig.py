"""Guided IG (util/attribution_methods/GIGBuilder.py, vendored from
PAIR-code/saliency).

Counterpart of ``xai_tpu/methods/gig.py``.  The adaptive path search
(guided_ig_impl, GIGBuilder.py:194-291) takes ``steps`` outer steps, each
with one softmax gradient, and a data-dependent inner search that moves the
features of smallest |gradient| toward the input until the path's L1
distance reaches the step's target.  The inner loop runs on the device
and asks the host once an iteration whether to go on.

One core serves a batch of images (``methods/batch.py``): each image's
inner search runs until its own exit, with its updates masked after it, as
xai_tpu's vmapped ``while_loop`` runs, and the loop ends when every image
has exited.  The reference's 'lower' quantile of |gradient| is
``torch.kthvalue`` (xai_tpu's bit-pattern search for the same order
statistic, inf included).
"""
from __future__ import annotations

import math

import torch

EPSILON = 1e-9
MAX_INNER = 4096


def _softmax_grad(bundle, xc: torch.Tensor, targets) -> torch.Tensor:
    """d softmax(logits)[target] / d input of an NCHW batch, float32.  The
    softmax runs in float32, or in float64 for a float64 model."""
    x = xc.detach().to(bundle.dtype).requires_grad_(True)
    with torch.enable_grad():
        logits = bundle.apply(x)
        probs = torch.softmax(logits.to(torch.promote_types(
            logits.dtype, torch.float32)), dim=-1)
        (g,) = torch.autograd.grad(probs.gather(1, targets[:, None]).sum(),
                                   x)
    return g.float()


def _per_image(v: torch.Tensor) -> torch.Tensor:
    """``[B]`` -> ``[B, 1, 1, 1]``."""
    return v.view(-1, 1, 1, 1)


def guided_ig_batch(bundle, xs: torch.Tensor, targets: torch.Tensor,
                    steps: int = 50, fraction: float = 0.5,
                    max_dist: float = 1.0, baselines=None) -> torch.Tensor:
    """Guided IG of an NCHW float32 batch toward per-image targets (int64
    ``[B]``) from ``baselines`` (zeros when None).  Returns the
    ``[B, C, H, W]`` attributions, float32."""
    x_input = xs.float()
    x_base = (torch.zeros_like(x_input) if baselines is None
              else baselines.float())
    b = x_input.shape[0]
    n = x_input[0].numel()
    q_idx = int(math.floor(fraction * (n - 1)))
    diff = x_input - x_base
    l1_total = diff.abs().sum(dim=(1, 2, 3))
    nz = diff != 0
    safe = torch.where(nz, diff, 1.0)
    xc = x_base
    attr = torch.zeros_like(x_input)
    for step in range(steps):
        grad_actual = _softmax_grad(bundle, xc, targets)
        # the reference's float32 step arithmetic
        frac = (torch.tensor(step, dtype=torch.float32, device=xs.device)
                + 1.0) / steps
        alpha_min = torch.clamp(frac - max_dist, min=0.0)
        alpha_max = torch.clamp(frac + max_dist, max=1.0)
        x_min = x_base + diff * alpha_min
        x_max = x_base + diff * alpha_max
        l1_target = l1_total * (1 - frac)
        live = torch.ones(b, dtype=torch.bool, device=xs.device)
        for _ in range(MAX_INNER):
            ratio = torch.where(nz, (xc - x_base) / safe, alpha_max)
            xc1 = torch.where(ratio < alpha_min, x_min, xc)
            l1_current = (xc1 - x_input).abs().sum(dim=(1, 2, 3))
            close = (l1_target - l1_current).abs() <= torch.clamp(
                EPSILON * torch.maximum(l1_target.abs(), l1_current.abs()),
                min=EPSILON)
            grad_iter = torch.where(xc1 == x_max, torch.inf, grad_actual)
            a = grad_iter.abs().flatten(1)
            thr = torch.kthvalue(a, q_idx + 1, dim=1).values
            s = (a <= thr[:, None]).view_as(xc1) & (grad_iter != torch.inf)
            l1_s = ((xc1 - x_max).abs() * s).sum(dim=(1, 2, 3))
            gamma = torch.where(l1_s > 0, (l1_current - l1_target) / l1_s,
                                torch.inf)
            g4 = _per_image(gamma)
            moved = torch.where(
                s, torch.where(g4 > 1.0, x_max,
                               torch.addcmul(xc1, x_max - xc1, g4)), xc1)
            new_xc = torch.where(_per_image(close), xc1, moved)
            new_attr = torch.addcmul(attr, new_xc - xc, grad_actual)
            # l1_s == 0: no selectable feature can move, and the
            # reference's `while` would spin; exit as xai_tpu does
            stuck = ~close & (l1_s <= 0)
            act = _per_image(live)
            xc = torch.where(act, new_xc, xc)
            attr = torch.where(act, new_attr, attr)
            # an image goes on while gamma > 1 and it is neither close
            # nor stuck (gamma is 0 once close)
            live = live & ~(close | stuck) & (gamma > 1.0)
            if not bool(live.any()):
                break
    return attr


def guided_ig(bundle, x: torch.Tensor, target: int, steps: int = 50,
              fraction: float = 0.5, max_dist: float = 1.0,
              baseline=None) -> torch.Tensor:
    """GuidedIG.GetMask with the driver's config x_steps=50, max_dist=1.0,
    fraction=0.5 (evaluatePerturbation.py:114-118) on a normalized
    ``[H, W, C]`` input.  Returns [H, W, C]."""
    xs = x.float().permute(2, 0, 1)[None]
    base = (None if baseline is None else torch.as_tensor(
        baseline, dtype=torch.float32, device=x.device).expand_as(x)
        .permute(2, 0, 1)[None])
    if float((xs - (0.0 if base is None else base)).abs().sum()) == 0:
        return torch.zeros_like(x, dtype=torch.float32)
    tg = torch.tensor([target], device=x.device)
    return guided_ig_batch(bundle, xs, tg, steps, fraction, max_dist,
                           base)[0].permute(1, 2, 0)
