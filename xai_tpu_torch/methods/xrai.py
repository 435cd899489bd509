"""XRAI — region-based attribution (util/attribution_methods/XRAIBuilder.py,
vendored PAIR-code/saliency).

Counterpart of ``xai_tpu/methods/xrai.py``: host numpy, the same code on
the port's own native segmenter.

Driver usage (evaluatePerturbation.py:142-146): base attribution = IG map,
so only the segment machinery + greedy gain-density ranking are needed:
- Felzenszwalb over-segmentation at scales [50,100,150,250,500,1200],
  sigma 0.8, min_size 150, on the image normalized to [-1, 1]
  (XRAIBuilder.py:37-41, 200-259), each segment dilated by disk(5);
- greedy growth by attribution gain density (_xrai, :619-713).

Segmentation runs in native C++ (xai_tpu_torch.native); per-segment attribution
sums are vectorized numpy (bincount) — the greedy loop itself is O(masks²)
host bookkeeping over boolean arrays.
"""
from __future__ import annotations

import numpy as np
from scipy.ndimage import binary_dilation

from ..native import felzenszwalb

SCALE_VALUES = (50, 100, 150, 250, 500, 1200)
SIGMA = 0.8
MIN_SEGMENT_SIZE = 150
DILATION_RAD = 5


def _disk(radius: int) -> np.ndarray:
    y, x = np.ogrid[-radius:radius + 1, -radius:radius + 1]
    return (x * x + y * y) <= radius * radius


def _normalize_image(im: np.ndarray, value_range=(-1.0, 1.0)) -> np.ndarray:
    im = im.astype(np.float64)
    im = (im - im.min()) / max(im.max() - im.min(), 1e-12)
    return im * (value_range[1] - value_range[0]) + value_range[0]


def get_segments(im: np.ndarray, dilation_rad: int = DILATION_RAD) -> list:
    """Boolean masks from multi-scale Felzenszwalb + dilation.

    The six scales are independent, and both the C++ felzenszwalb (ctypes)
    and scipy's binary_dilation release the GIL — threading them is the
    whole method's hot spot (~175 ms of XRAI's ~210 ms/image on one core).
    Mask order is kept identical to the sequential loop (scale-major,
    label-ascending), so results are bit-identical."""
    from concurrent.futures import ThreadPoolExecutor

    im = _normalize_image(im)
    selem = _disk(dilation_rad)
    imf = im.astype(np.float32)

    def one_scale(scale):
        seg = felzenszwalb(imf, scale=float(scale), sigma=SIGMA,
                           min_size=MIN_SEGMENT_SIZE)
        out = []
        for l in range(seg.min(), seg.max() + 1):
            mask = seg == l
            if mask.any():
                if dilation_rad:
                    mask = binary_dilation(mask, structure=selem)
                out.append(mask)
        return out

    with ThreadPoolExecutor(min(6, len(SCALE_VALUES))) as ex:
        per_scale = list(ex.map(one_scale, SCALE_VALUES))
    return [m for masks in per_scale for m in masks]


def _gain_density(mask1, attr, mask2=None):
    added = mask1 if mask2 is None else (mask1 & ~mask2)
    if not added.any():
        return -np.inf
    return attr[added].mean()


def xrai_full(attr: np.ndarray, segs: list, area_perc_th: float = 1.0,
              min_pixel_diff: int = 50) -> np.ndarray:
    """_xrai greedy growth (XRAIBuilder.py:619-713)."""
    output_attr = -np.inf * np.ones(attr.shape, dtype=float)
    current_mask = np.zeros(attr.shape, dtype=bool)
    current_area_perc = 0.0
    remaining = {i: m for i, m in enumerate(segs)}

    while current_area_perc <= area_perc_th:
        best_gain = -np.inf
        best_key = None
        remove_queue = []
        for key, mask in remaining.items():
            diff_cnt = int((mask & ~current_mask).sum())
            if diff_cnt < min_pixel_diff:
                remove_queue.append(key)
                continue
            gain = _gain_density(mask, attr, current_mask)
            if gain > best_gain:
                best_gain = gain
                best_key = key
        for key in remove_queue:
            del remaining[key]
        if not remaining:
            break
        if best_key is None:
            # every gain compared False (NaN base attribution) — the
            # reference crashes here (XRAIBuilder.py:661-689 indexes
            # remaining_masks[None]); degrade to the -inf fill instead
            break
        added = remaining[best_key]
        diff = added & ~current_mask
        current_mask |= added
        current_area_perc = current_mask.mean()
        output_attr[diff] = best_gain
        del remaining[best_key]

    uncomputed = output_attr == -np.inf
    if uncomputed.any():
        output_attr[uncomputed] = _gain_density(uncomputed, attr)
    return output_attr


def xrai_fast(attr: np.ndarray, segs: list,
              min_pixel_diff: int = 50) -> np.ndarray:
    """_xrai_fast (XRAIBuilder.py:714-788): rank all masks by gain density
    once (ignoring overlap), then assign diff-gains in that order."""
    output_attr = -np.inf * np.ones(attr.shape, dtype=float)
    current_mask = np.zeros(attr.shape, dtype=bool)
    gains = [_gain_density(m, attr) for m in segs]
    order = sorted(range(len(segs)), key=lambda i: -gains[i])
    for i in order:
        added = segs[i]
        diff = added & ~current_mask
        if int(diff.sum()) < min_pixel_diff:
            continue
        output_attr[diff] = _gain_density(diff, attr)
        current_mask |= added
    uncomputed = output_attr == -np.inf
    if uncomputed.any():
        output_attr[uncomputed] = _gain_density(uncomputed, attr)
    return output_attr


def xrai(img_for_segments: np.ndarray,
         base_attribution: np.ndarray, segs=None) -> np.ndarray:
    """GetMask with precomputed base attribution (the driver's only path).
    img_for_segments: [H, W, C]; base_attribution: [H, W, C] (IG map).
    attr aggregation = max over channels (XRAIBuilder.py:262-263, 572-577).
    ``segs`` injects precomputed segment masks (golden-parity protocol —
    the reference GetMask accepts the same, XRAIBuilder.py:415-470).
    Returns [H, W]."""
    attr = np.asarray(base_attribution).max(axis=-1)
    if segs is None:
        segs = get_segments(np.asarray(img_for_segments))
    return xrai_full(attr, segs)
