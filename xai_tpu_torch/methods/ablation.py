"""Perturbation-based captum-equivalents: GradientShap, FeatureAblation,
Occlusion, ShapleyValueSampling.

Counterpart of ``xai_tpu/methods/ablation.py`` (reference usage:
evaluatePerturbation.py:164-176).  Each method is one core over an NCHW
batch with one target per row, which the per-image functions call with a
batch of one and ``methods/batch.py`` with the driver's batch.  The
forwards of FeatureAblation, Occlusion and Shapley sampling are one flat
chunked sweep (``gradient._flat_logits``) whose images are built chunk by
chunk from the input and a replacement mask.

Random draws come from the image's ``torch.Generator`` in one fixed order
(:func:`gs_draws`, :func:`shapley_perms`), so the per-image and batched
paths agree on generators seeded alike; ``baselines=`` / ``alphas=`` /
``base_idx=`` and ``perms=`` inject the draws instead, as xai_tpu's
hooks do.  The public functions take a normalized ``[H, W, C]`` input on
the model's device and return ``[H, W, 3]``.
"""
from __future__ import annotations

import torch

from ..models.common import target_scores
from .gradient import _fit_chunk, _flat_logits


def patch_mask(img_hw: int = 224, num_patches: int = 14,
               device=None) -> torch.Tensor:
    """[H, W] int64 mask of num_patches^2 patch ids, row-major — the
    driver's feature mask (evaluatePerturbation.py:94-97).  Pixel i lies
    in patch row floor(i * num_patches / img_hw): xai_tpu's square
    patches where num_patches divides img_hw (xai_tpu runs no other
    size), patches one pixel apart in size where it does not (TINY_R's
    64 px)."""
    ids = torch.arange(img_hw, device=device) * num_patches // img_hw
    return ids[:, None] * num_patches + ids[None, :]


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(2, 0, 1)[None]


def _hwc3(m: torch.Tensor) -> torch.Tensor:
    """[H, W] -> [H, W, 3], the map broadcast over the channels."""
    return m[..., None].expand(m.shape + (3,))


def _row_targets(targets, b: int, device) -> torch.Tensor:
    """One class for every image, or one a row, as int64 ``[b]``."""
    tg = torch.as_tensor(targets, dtype=torch.int64, device=device).view(-1)
    return tg.expand(b) if tg.numel() == 1 else tg


@torch.no_grad()
def _target_logits(bundle, xs: torch.Tensor, targets) -> torch.Tensor:
    return target_scores(bundle.apply(xs.to(bundle.dtype)).float(), targets)


# ---------------------------------------------------------------------------
# GradientShap (captum defaults: n_samples=5, stdevs=0.0)
# ---------------------------------------------------------------------------

def gs_draws(x: torch.Tensor, generator: torch.Generator,
             n_samples: int = 5, baselines=None, alphas=None, base_idx=None):
    """GradientShap's draws for one ``[H, W, C]`` image, in xai_tpu's
    order: one random-normal baseline ``[1, H, W, C]``, the baseline index
    of each sample, then one uniform alpha a sample.  Each draw that is
    given is not drawn."""
    dev = x.device

    def need():
        if generator is None:
            raise ValueError("gradient_shap needs a generator or its draws")
        return generator

    if baselines is None:
        baselines = torch.randn((1,) + tuple(x.shape), dtype=x.dtype,
                                device=dev, generator=need())
    baselines = torch.as_tensor(baselines, dtype=x.dtype, device=dev)
    if alphas is not None:
        n_samples = int(alphas.shape[0])
    if base_idx is None:
        base_idx = torch.randint(0, baselines.shape[0], (n_samples,),
                                 device=dev, generator=need())
    if alphas is None:
        alphas = torch.rand(n_samples, device=dev, generator=need())
    return (baselines,
            torch.as_tensor(alphas, dtype=torch.float32, device=dev),
            torch.as_tensor(base_idx, dtype=torch.int64, device=dev))


def gradient_shap_batch(bundle, xs: torch.Tensor, targets, draws
                        ) -> torch.Tensor:
    """GradientShap of an NCHW batch ``[B, C, H, W]``; ``draws``: one
    :func:`gs_draws` triple an image.  All B·n points go through one
    batched forward and backward.  Returns ``[B, C, H, W]``."""
    base = torch.stack([bl.permute(0, 3, 1, 2)[idx]
                        for bl, _, idx in draws])        # [B, n, C, H, W]
    alphas = torch.stack([a for _, a, _ in draws])        # [B, n]
    n = alphas.shape[1]
    diff = xs[:, None] - base
    pts = torch.addcmul(base, alphas[..., None, None, None], diff)
    tg = _row_targets(targets, xs.shape[0], xs.device).repeat_interleave(n)
    g, _ = bundle.score_and_grad(pts.flatten(0, 1).to(bundle.dtype), tg)
    return (g.view_as(diff) * diff).mean(dim=1)


def gradient_shap(bundle, x: torch.Tensor, target: int, generator=None,
                  baselines=None, n_samples: int = 5, alphas=None,
                  base_idx=None) -> torch.Tensor:
    """captum GradientShap with a single random-normal baseline
    (evaluatePerturbation.py:164-167).  Returns [H, W, C]."""
    draws = gs_draws(x, generator, n_samples, baselines, alphas, base_idx)
    return gradient_shap_batch(bundle, _nchw(x), target, [draws])[0] \
        .permute(1, 2, 0)


# ---------------------------------------------------------------------------
# FeatureAblation and Occlusion: forwards with a region replaced
# ---------------------------------------------------------------------------

def _ablation_diffs(bundle, xs: torch.Tensor, targets, masks: torch.Tensor,
                    baseline: float, chunk: int) -> torch.Tensor:
    """f(x) - f(x with ``masks[g]`` set to baseline) for every image and
    region: xs ``[B, C, H, W]``, masks bool ``[G, H, W]`` -> ``[B, G]``.
    Row ``b * G + g`` of the sweep is image b with region g replaced."""
    b, g = xs.shape[0], masks.shape[0]
    tg = _row_targets(targets, b, xs.device)

    def build(lo, hi):
        r = torch.arange(lo, hi, device=xs.device)
        return torch.where(masks[r % g][:, None], baseline, xs[r // g])

    scores = _flat_logits(bundle, b * g, build, tg.repeat_interleave(g),
                          chunk)
    return _target_logits(bundle, xs, tg)[:, None] - scores.view(b, g)


def feature_ablation_batch(bundle, xs: torch.Tensor, targets,
                           num_patches: int = 14, baseline: float = 0.0,
                           chunk: int = 49) -> torch.Tensor:
    """captum FeatureAblation over the patch groups of an NCHW batch:
    ``[B, H, W]`` maps, each group's score drop broadcast over it."""
    mask = patch_mask(xs.shape[-1], num_patches, xs.device)
    n = num_patches ** 2
    groups = mask == torch.arange(n, device=xs.device)[:, None, None]
    diffs = _ablation_diffs(bundle, xs, targets, groups, baseline,
                            _fit_chunk(n, chunk) * xs.shape[0])
    return diffs[:, mask]


def feature_ablation(bundle, x: torch.Tensor, target: int,
                     num_patches: int = 14, baseline: float = 0.0,
                     chunk: int = 49) -> torch.Tensor:
    """captum FeatureAblation: per patch group, attribution =
    f(x) - f(x with group ablated to baseline), broadcast over the group."""
    return _hwc3(feature_ablation_batch(bundle, _nchw(x), target,
                                        num_patches, baseline, chunk)[0])


def occlusion_batch(bundle, xs: torch.Tensor, targets, window: int = 64,
                    stride: int = 32, baseline: float = 0.0,
                    chunk: int = 36) -> torch.Tensor:
    """captum Occlusion of an NCHW batch: each window position's score
    drop spread over its pixels, averaged by coverage count.  Returns
    ``[B, H, W]``."""
    hw = xs.shape[-1]
    n_pos = (hw - window) // stride + 1
    start = torch.arange(n_pos, device=xs.device) * stride
    rr = torch.arange(hw, device=xs.device)
    inside = (rr >= start[:, None]) & (rr < start[:, None] + window)
    wins = (inside[:, None, :, None] & inside[None, :, None, :]).flatten(0, 1)
    n = n_pos * n_pos
    diffs = _ablation_diffs(bundle, xs, targets, wins, baseline,
                            _fit_chunk(n, chunk) * xs.shape[0])
    cover = wins.to(torch.float32)
    tot = torch.einsum("bp,phw->bhw", diffs, cover)
    return tot / cover.sum(dim=0).clamp(min=1.0)


def occlusion(bundle, x: torch.Tensor, target: int, window: int = 64,
              stride: int = 32, baseline: float = 0.0,
              chunk: int = 36) -> torch.Tensor:
    """captum Occlusion with sliding_window_shapes=(3,64,64), strides=32
    (evaluatePerturbation.py:174-176)."""
    return _hwc3(occlusion_batch(bundle, _nchw(x), target, window, stride,
                                 baseline, chunk)[0])


# ---------------------------------------------------------------------------
# Shapley Value Sampling over patch groups
# ---------------------------------------------------------------------------

def shapley_perms(generator: torch.Generator, n_groups: int,
                  n_samples: int = 25) -> torch.Tensor:
    """``[n_samples, n_groups]`` random permutations of the groups, drawn
    one after another from ``generator``."""
    return torch.stack([torch.randperm(n_groups, generator=generator,
                                       device=generator.device)
                        for _ in range(n_samples)])


def shapley_batch(bundle, xs: torch.Tensor, targets, perms: torch.Tensor,
                  num_patches: int = 14, baseline: float = 0.0,
                  chunk: int = 49) -> torch.Tensor:
    """captum ShapleyValueSampling of an NCHW batch: perms ``[B, S, G]``.
    Along each permutation, the coalition after step s holds its first s
    groups; a group's contribution is the score change when it joins,
    averaged over the permutations.  One flat sweep over the B·S·(G+1)
    coalitions (xai_tpu pads each permutation's G+1 steps to a chunk
    multiple; those forwards change nothing and are not run).  Returns
    ``[B, H, W]``."""
    b, s, g = perms.shape
    mask = patch_mask(xs.shape[-1], num_patches, xs.device)
    # group -> its position in the permutation
    pos = torch.empty_like(perms).scatter_(
        -1, perms, torch.arange(g, device=perms.device).expand_as(perms))
    pix_pos = pos[..., mask].flatten(0, 1)               # [B*S, H, W]
    tg = _row_targets(targets, b, xs.device)

    def build(lo, hi):
        r = torch.arange(lo, hi, device=xs.device)
        step = (r % (g + 1)).view(-1, 1, 1)
        keep = pix_pos[r // (g + 1)] < step
        return torch.where(keep[:, None], xs[r // ((g + 1) * s)], baseline)

    scores = _flat_logits(bundle, b * s * (g + 1), build,
                          tg.repeat_interleave(s * (g + 1)),
                          chunk * b).view(b, s, g + 1)
    marginal = scores[..., 1:] - scores[..., :-1]        # of perm[:, :, i]
    group_attr = marginal.gather(-1, pos).mean(dim=1)    # [B, G]
    return group_attr[:, mask]


def shapley_sampling(bundle, x: torch.Tensor, target: int, generator=None,
                     num_patches: int = 14, n_samples: int = 25,
                     baseline: float = 0.0, chunk: int = 49,
                     perms=None) -> torch.Tensor:
    """captum ShapleyValueSampling over the driver's patch groups
    (imagenet_seg_eval.py:160).  ``perms`` (``[n_samples,
    num_patches**2]``) injects the permutations."""
    if perms is None:
        if generator is None:
            raise ValueError("shapley_sampling needs a generator or perms")
        perms = shapley_perms(generator, num_patches ** 2, n_samples)
    perms = torch.as_tensor(perms, dtype=torch.int64, device=x.device)
    return _hwc3(shapley_batch(bundle, _nchw(x), target, perms[None],
                               num_patches, baseline, chunk)[0])
