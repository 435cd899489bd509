"""LRP-style heatmap rendering (evaluations/utils/render.py equivalent):
signed relevance -> RGB heatmap via the classic firered colormap, plus
overlay helpers.

Counterpart of ``xai_tpu/utils/render.py``, host numpy and scipy.
"""
from __future__ import annotations

import numpy as np


def _standardize(x: np.ndarray) -> np.ndarray:
    x = x / np.max(np.abs(x)) if np.max(np.abs(x)) > 0 else x
    return (x + 1.0) / 2.0


def hm_to_rgb(relevance: np.ndarray, X: np.ndarray | None = None,
              scaling: int = 1, sigma: float = 2.0) -> np.ndarray:
    """[H, W] signed relevance -> [H*s, W*s, 3] float RGB in [0, 1]
    (render.heatmap semantics: blue-white-red diverging).

    When ``X`` (an [H, W] grayscale template of the input) is given, a
    black canny-edge outline of it is multiplied onto the heatmap — the
    reference's documented X/sigma path
    (evaluations/utils/render.py:153-190; their edge draw is commented
    out upstream, the documented ``rgb *= ~edges`` semantics are kept).
    """
    r = np.repeat(np.repeat(relevance, scaling, 0), scaling, 1)
    v = _standardize(r)
    red = np.clip(2.0 * v - 1.0, 0, 1)
    blue = np.clip(1.0 - 2.0 * v, 0, 1)
    green = 1.0 - red - blue
    rgb = np.stack([red + green, green + 0.0 * v, blue + green], axis=-1)
    if X is not None:
        Xl = np.repeat(np.repeat(np.asarray(X, np.float64), scaling, 0),
                       scaling, 1)
        if Xl.shape == rgb.shape[:2]:
            edges = canny(Xl, sigma=sigma)
            rgb = rgb * (~np.dstack([edges] * 3)).astype(rgb.dtype)
    return rgb


def canny(image: np.ndarray, sigma: float = 2.0,
          low_frac: float = 0.1, high_frac: float = 0.2) -> np.ndarray:
    """Canny edge detector (native numpy/scipy; replaces
    skimage.feature.canny for the outline path): gaussian smooth ->
    sobel gradients -> 4-direction non-maximum suppression -> double
    threshold (fractions of the max magnitude) -> hysteresis via
    connected-component labeling.  Returns a boolean [H, W] edge mask.
    """
    from scipy import ndimage

    img = np.asarray(image, np.float64)
    rng = img.max() - img.min()
    if rng > 0:
        img = (img - img.min()) / rng
    sm = ndimage.gaussian_filter(img, sigma, mode="nearest")
    gx = ndimage.sobel(sm, axis=1, mode="nearest")
    gy = ndimage.sobel(sm, axis=0, mode="nearest")
    mag = np.hypot(gx, gy)
    if mag.max() == 0:
        return np.zeros(img.shape, bool)
    # quantize gradient direction into 4 bins and suppress non-maxima
    ang = np.rad2deg(np.arctan2(gy, gx)) % 180.0
    p = np.pad(mag, 1, mode="constant")
    c = p[1:-1, 1:-1]
    nbrs = {
        0: (p[1:-1, 2:], p[1:-1, :-2]),      # E/W
        1: (p[:-2, 2:], p[2:, :-2]),         # NE/SW
        2: (p[:-2, 1:-1], p[2:, 1:-1]),      # N/S
        3: (p[:-2, :-2], p[2:, 2:]),         # NW/SE
    }
    dbin = ((ang + 22.5) // 45.0).astype(int) % 4
    keep = np.zeros(img.shape, bool)
    for b, (n1, n2) in nbrs.items():
        sel = dbin == b
        keep |= sel & (c >= n1) & (c >= n2)
    nms = np.where(keep, mag, 0.0)
    high = high_frac * nms.max()
    low = low_frac * nms.max()
    strong = nms >= high
    weak = nms >= low
    # hysteresis: keep weak components that touch a strong pixel
    labels, n = ndimage.label(weak, structure=np.ones((3, 3), int))
    if n == 0:
        return strong
    touching = np.unique(labels[strong & (labels > 0)])
    mask = np.isin(labels, touching) & weak
    return mask


def overlay(image: np.ndarray, heatmap_rgb: np.ndarray,
            alpha: float = 0.5) -> np.ndarray:
    """Alpha-blend a heatmap over an [H, W, 3] image in [0, 1]."""
    return np.clip((1 - alpha) * image + alpha * heatmap_rgb, 0, 1)
