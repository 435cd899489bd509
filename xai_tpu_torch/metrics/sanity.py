"""Adebayo sanity checks (util/test_methods/sanityForMethods.py +
evaluateSanity.py): attribution similarity between trained and
weight-randomized models, measured by SSIM, Spearman, and HOG-feature
Spearman; plus the independent / cascading layer-randomization machinery.

Counterpart of ``xai_tpu/metrics/sanity.py``.  The metrics are its host
numpy and scipy code, copied: SSIM matches
skimage.structural_similarity(gaussian_weights=True): sigma 1.5, truncate
3.5 (win 11), no sample-covariance correction, data_range 2.0 (skimage's
float dtype_range default the reference hits by not passing data_range).
HOG matches skimage.feature.hog defaults at pixels_per_cell=(16,16): 9
unsigned orientation bins, (3,3) cell blocks, L2-Hys normalization,
per-pixel max-gradient channel selection.

The randomizers act on the port's state dict (``nn.Module.state_dict()``
names) and draw ``U[0, 1)`` from an explicit ``torch.Generator``, as the
reference's ``torch.rand`` does; xai_tpu draws them with ``jax.random``,
so the two never draw alike.
"""
from __future__ import annotations

import re

import numpy as np
import torch
from scipy.ndimage import gaussian_filter

from ..ops.stats import spearman_np


def normalize_image(x: np.ndarray) -> np.ndarray:
    x = np.asarray(x, np.float32).copy()
    x[x == np.inf] = 0
    x[x == -np.inf] = 0
    rng = x.max() - x.min()
    if rng == 0:
        # constant map (LIME with no positive segments produces one): the
        # reference's 0/0 here NaN-poisons the whole run's accumulated
        # SSIM/HOG totals — degrade to an all-zero map instead
        return np.zeros_like(x)
    return (x - x.min()) / rng


def ssim(a: np.ndarray, b: np.ndarray, data_range: float = 2.0,
         sigma: float = 1.5, truncate: float = 3.5,
         K1: float = 0.01, K2: float = 0.03) -> float:
    """Gaussian-weighted SSIM over [H, W] or mean over channels of
    [H, W, C]."""
    if a.ndim == 3:
        return float(np.mean([ssim(a[..., c], b[..., c], data_range, sigma,
                                   truncate, K1, K2)
                              for c in range(a.shape[2])]))
    a = a.astype(np.float64)
    b = b.astype(np.float64)

    def filt(x):
        return gaussian_filter(x, sigma, truncate=truncate)

    ua, ub = filt(a), filt(b)
    uaa, ubb, uab = filt(a * a), filt(b * b), filt(a * b)
    va = uaa - ua * ua
    vb = ubb - ub * ub
    vab = uab - ua * ub
    C1 = (K1 * data_range) ** 2
    C2 = (K2 * data_range) ** 2
    S = ((2 * ua * ub + C1) * (2 * vab + C2)) / \
        ((ua ** 2 + ub ** 2 + C1) * (va + vb + C2))
    pad = int(truncate * sigma + 0.5)
    return float(S[pad:-pad, pad:-pad].mean())


def hog(image: np.ndarray, orientations: int = 9,
        pixels_per_cell=(16, 16), cells_per_block=(3, 3)) -> np.ndarray:
    """skimage-style HOG descriptor of [H, W] or [H, W, C] float image."""
    img = np.asarray(image, np.float64)
    if img.ndim == 2:
        img = img[..., None]
    H, W, C = img.shape

    g_row = np.zeros_like(img)
    g_col = np.zeros_like(img)
    g_row[1:-1] = img[2:] - img[:-2]
    g_col[:, 1:-1] = img[:, 2:] - img[:, :-2]
    mag = np.hypot(g_row, g_col)
    best = mag.argmax(axis=2)
    ii, jj = np.mgrid[0:H, 0:W]
    g_row = g_row[ii, jj, best]
    g_col = g_col[ii, jj, best]
    mag = mag[ii, jj, best]

    ori = np.rad2deg(np.arctan2(g_row, g_col)) % 180.0
    cy, cx = pixels_per_cell
    ncy, ncx = H // cy, W // cx
    bin_width = 180.0 / orientations
    bins = np.minimum((ori // bin_width).astype(int), orientations - 1)

    hist = np.zeros((ncy, ncx, orientations))
    for o in range(orientations):
        sel = np.where(bins == o, mag, 0.0)[:ncy * cy, :ncx * cx]
        hist[:, :, o] = sel.reshape(ncy, cy, ncx, cx).mean(axis=(1, 3))

    by, bx = cells_per_block
    nby, nbx = ncy - by + 1, ncx - bx + 1
    out = np.zeros((nby, nbx, by, bx, orientations))
    for i in range(nby):
        for j in range(nbx):
            block = hist[i:i + by, j:j + bx]
            norm = np.sqrt((block ** 2).sum() + 1e-10)
            block = block / norm
            block = np.minimum(block, 0.2)
            norm = np.sqrt((block ** 2).sum() + 1e-10)
            out[i, j] = block / norm
    return out.ravel()


def evaluate(normal_attr: np.ndarray, random_attr: np.ndarray):
    """(ssim, spearman, hog-spearman) — sanityForMethods.py:75-92.
    Inputs are [H, W, C] or [H, W] maps."""
    n01 = normalize_image(normal_attr)
    r01 = normalize_image(random_attr)
    spr_val = float(spearman_np(np.asarray(normal_attr).ravel(),
                                np.asarray(random_attr).ravel()))
    ssim_val = ssim(n01, r01)
    hog_val = float(spearman_np(hog(n01), hog(r01)))
    return ssim_val, spr_val, hog_val


# ---------------------------------------------------------------------------
# weight randomization (evaluateSanity.py:108-145 + sanityForMethods.py)
# ---------------------------------------------------------------------------

# a state-dict name's top-level group: xai_tpu's top-level parameter key
# (``layer3_7``) is the port's ``layer3.7`` (convert/from_jax.py)
_GROUP = re.compile(r"^(layer\d+\.\d+|[^.]+)\.")


def randomize_params(state: dict, generator: torch.Generator,
                     layer_prefixes=None) -> dict:
    """Re-initialize (uniform [0,1), matching torch.rand in
    independent_layer_rand) every tensor whose name starts with one of
    ``layer_prefixes`` (None = all of them), in the state dict's order,
    drawn on ``generator``'s device — the layer-randomization primitive
    behind both sanity drivers.  Returns a new state dict."""
    out = {}
    for name, t in state.items():
        if layer_prefixes is None or any(name.startswith(p)
                                         for p in layer_prefixes):
            t = torch.rand(t.shape, generator=generator,
                           device=generator.device).to(t.device, t.dtype)
        out[name] = t
    return out


def top_level_layers(state: dict) -> list:
    """The reference's get_layers (sanityForMethods.py:10-18): unique
    top-level parameter groups, in xai_tpu's order, which sorts its
    parameter keys (``bn1``, ``conv1``, ``fc``, ``layer1_0``, ...)."""
    groups = dict.fromkeys(_GROUP.match(n).group(1) for n in state)
    return sorted(groups, key=lambda g: g.replace(".", "_"))


def cascading_randomize(state: dict, generator: torch.Generator,
                        index: int) -> dict:
    """Randomize layers 0..index (cascading_layer_rand :42-58)."""
    layers = top_level_layers(state)
    return randomize_params(state, generator,
                            [g + "." for g in layers[:index + 1]])


def independent_randomize(state: dict, generator: torch.Generator,
                          layer: str) -> dict:
    return randomize_params(state, generator, [layer + "."])
