"""AGI — Adversarial Gradient Integration (util/attribution_methods/AGI.py).

Counterpart of ``xai_tpu/methods/agi.py``.  Targeted PGD ascent toward
false classes on the *unnormalized* image (the normalization composed into
the model, evaluatePerturbation.py:126-127), accumulating
``-grad_label * delta_x`` as the attribution.

Each iteration takes one forward and the two softmax gradients (toward the
attacked class and of the label class), and restarts from the ORIGINAL
image (the reference passes ``image``, not ``perturbed_image``, AGI.py:
62-63).  An image's updates stop after the first iteration that starts at
the attacked class; xai_tpu masks every later iteration, and the loop here
ends once every image of the batch has stopped (one host sync an
iteration).  The per-image and batched paths share one core over an NCHW
batch.
"""
from __future__ import annotations

import torch


def _norm_apply(bundle, x: torch.Tensor) -> torch.Tensor:
    """Logits of the model on ``x`` in [0, 1], NCHW, normalized by the
    bundle's mean and std and cast to the module's dtype; float32, or
    float64 for a float64 model."""
    mean = torch.tensor(bundle.meta.mean, device=x.device).view(1, -1, 1, 1)
    std = torch.tensor(bundle.meta.std, device=x.device).view(1, -1, 1, 1)
    logits = bundle.apply(((x - mean) / std).to(bundle.dtype))
    return logits.to(torch.promote_types(logits.dtype, torch.float32))


def _agi_attack(bundle, img: torch.Tensor, init_pred: torch.Tensor,
                targeted: int, max_iter: int, epsilon: float
                ) -> torch.Tensor:
    """Targeted PGD of every image of ``img`` toward class ``targeted``;
    returns the cumulative deltas (AGI.py:52-80)."""
    perturbed = img
    c_delta = torch.zeros_like(img)
    done = torch.zeros(img.shape[0], dtype=torch.bool, device=img.device)
    tg = torch.full_like(init_pred, targeted)[:, None]
    for _ in range(max_iter):
        xg = perturbed.detach().requires_grad_(True)
        with torch.enable_grad():
            probs = torch.softmax(_norm_apply(bundle, xg), dim=-1)
            (g_adv,) = torch.autograd.grad(probs.gather(1, tg).sum(), xg,
                                           retain_graph=True)
            (g_lab,) = torch.autograd.grad(
                probs.gather(1, init_pred[:, None]).sum(), xg)
        newly_done = probs.detach().argmax(dim=-1) == targeted
        # fgsm_step (AGI.py:39-49) from the original image
        new_pert = torch.clamp(img + epsilon * torch.sign(g_adv), 0.0, 1.0)
        delta = -g_lab * (new_pert - img)
        active = ~(done | newly_done)[:, None, None, None]
        perturbed = torch.where(active, new_pert, perturbed)
        c_delta = torch.where(active, c_delta + delta, c_delta)
        done = done | newly_done
        if bool(done.all()):
            break
    return c_delta


def agi_raw_batch(bundle, xs: torch.Tensor, selected, epsilon: float = 0.05,
                  max_iter: int = 20, dtype=None) -> torch.Tensor:
    """Summed per-target PGD deltas of an NCHW batch in [0, 1], before the
    percentile post-processing (AGI.py:83-115).  The initial prediction,
    which picks the skipped target and the label class, is always the
    float32 model's; ``dtype`` runs the attacks on the bundle's copy in
    that dtype.  An image skips its own predicted class."""
    with torch.no_grad():
        init_pred = _norm_apply(bundle, xs).argmax(dim=-1)
    sweep = bundle.cast(dtype)
    step_grad = torch.zeros_like(xs)
    for t in selected:
        own = init_pred == t
        if bool(own.all()):
            continue
        delta = _agi_attack(sweep, xs, init_pred, t, max_iter, epsilon)
        step_grad = step_grad + torch.where(own[:, None, None, None], 0.0,
                                            delta)
    return step_grad


def agi_raw(bundle, trans_img, selected, epsilon: float = 0.05,
            max_iter: int = 20) -> torch.Tensor:
    """agi_raw_batch of one ``[H, W, 3]`` image in [0, 1]; ``[H, W, 3]``."""
    x = torch.as_tensor(trans_img, dtype=torch.float32,
                        device=bundle.device).permute(2, 0, 1)[None]
    return agi_raw_batch(bundle, x, selected, epsilon, max_iter)[0] \
        .permute(1, 2, 0)


def _agi_post(step_grad: torch.Tensor) -> torch.Tensor:
    """Channel-mean + [80, 99]-percentile clip and rescale (AGI.py:
    130-139) of ``[B, C, H, W]`` deltas; ``[B, H, W]``.  torch.quantile's
    linear interpolation is jnp.percentile's."""
    hm = step_grad.mean(dim=1)
    q = torch.tensor([0.8, 0.99], device=hm.device)
    lo, hi = torch.quantile(hm.flatten(1), q, dim=1)[:, :, None, None]
    return (torch.minimum(torch.maximum(hm, lo), hi) - lo) / (hi - lo)


def agi_batch(bundle, trans_imgs, epsilon: float = 0.05, topk: int = 1,
              max_iter: int = 20, dtype=None) -> torch.Tensor:
    """AGI of ``[B, H, W, 3]`` images in [0, 1]: ``[B, H, W]`` maps.  The
    driver's attacked classes are range(0, 999, 1000 // topk)."""
    xs = torch.as_tensor(trans_imgs, dtype=torch.float32,
                         device=bundle.device).permute(0, 3, 1, 2)
    selected = range(0, 999, int(1000 / topk))
    return _agi_post(agi_raw_batch(bundle, xs, selected, epsilon, max_iter,
                                   dtype))


def agi(bundle, trans_img, epsilon: float = 0.05, topk: int = 1,
        max_iter: int = 20) -> torch.Tensor:
    """Driver configuration (evaluatePerturbation.py:119-139): attack the
    classes ``range(0, 999, 1000 // topk)``, sum deltas, then clip to the
    [80, 99] percentile band and rescale.  trans_img: [H, W, 3] in [0, 1].
    Returns the [H, W] map; an image whose prediction is the only attacked
    class has no delta and maps to 0/0 = NaN, as in xai_tpu."""
    return agi_batch(bundle, torch.as_tensor(trans_img)[None], epsilon, topk,
                     max_iter)[0]
