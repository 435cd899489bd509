"""PIC / SIC / AIC curves à la PAIR-code
(util/test_methods/PICTestFunctions.py).

Counterpart of ``xai_tpu/metrics/pic.py``: host numpy and scipy around
one forward a blurred image on the model's device.

- create_blurred_image: linear griddata inpainting from a sparse pixel mask
  (:34-90; scipy.interpolate.griddata, corners forced on);
- estimate_image_entropy: lossless-webp byte size proxy (:112-127, PIL);
- compute_pic_metric: threshold sweep -> (normalized entropy, normalized
  prediction) pairs -> monotone envelope -> interp1d -> trapezoid AUC
  (:193-348).  method: 0 = SIC (softmax), 1 = AIC (top-1 indicator).
"""
from __future__ import annotations

import io
from typing import NamedTuple, Sequence

import numpy as np
import torch
from scipy import interpolate

try:
    from PIL import Image
except ImportError:  # pragma: no cover
    Image = None

DEFAULT_THRESHOLDS = (0.005, 0.01, 0.02, 0.03, 0.04, 0.05, 0.07, 0.10,
                      0.13, 0.21, 0.34, 0.5, 0.75)


class PicResult(NamedTuple):
    curve_x: np.ndarray
    curve_y: np.ndarray
    auc: float


def create_blurred_image(full_img: np.ndarray,
                         pixel_mask: np.ndarray) -> np.ndarray:
    data_type = full_img.dtype
    has_color = full_img.ndim > 2
    if not has_color:
        full_img = full_img[..., None]
    channels = full_img.shape[2]

    pixel_mask = pixel_mask.copy()
    h, w = pixel_mask.shape
    pixel_mask[[0, 0, h - 1, h - 1], [0, w - 1, 0, w - 1]] = True
    mean_color = full_img.mean(axis=(0, 1))
    if pixel_mask.all():
        return full_img if has_color else full_img[..., 0]

    blurred = full_img * pixel_mask[..., None].astype(np.float32)
    data_points = np.argwhere(pixel_mask > 0)
    unknown = np.argwhere(pixel_mask == 0)
    for c in range(channels):
        vals = full_img[:, :, c][tuple(data_points.T)]
        interp = interpolate.griddata(data_points, vals, unknown,
                                      method="linear",
                                      fill_value=mean_color[c])
        blurred[:, :, c][tuple(unknown.T)] = interp
    if not has_color:
        blurred = blurred[..., 0]
    if issubclass(data_type.type, np.integer):
        blurred = np.round(blurred)
    return blurred.astype(data_type)


def generate_random_mask(h: int, w: int, fraction: float = 0.01,
                         rng=None) -> np.ndarray:
    rng = rng or np.random
    mask = np.zeros((h, w), dtype=bool)
    idx = rng.choice(mask.size, replace=False,
                     size=int(mask.size * fraction))
    mask[np.unravel_index(idx, mask.shape)] = True
    return mask


def estimate_image_entropy(image: np.ndarray) -> float:
    """The lossless WebP size in bytes (PIL's WebP encoder)."""
    if Image is None:
        raise ImportError("estimate_image_entropy needs PIL (Pillow)")
    buf = io.BytesIO()
    Image.fromarray(image).save(buf, format="webp", lossless=True,
                                quality=100)
    return float(buf.getbuffer().nbytes)


def _probs(bundle, arr, normalize_fn) -> np.ndarray:
    """Softmax probabilities of one ``[H, W, 3]`` image (in [0, 1], then
    ``normalize_fn`` on the ``[H, W, 3]`` tensor if given), one forward."""
    x = torch.as_tensor(np.asarray(arr), dtype=torch.float32,
                        device=bundle.device)
    if normalize_fn is not None:
        x = normalize_fn(x)
    return bundle.probs(x.permute(2, 0, 1)[None].contiguous())[0] \
        .cpu().numpy()


def compute_pic_metric(bundle, img, saliency_map, random_mask,
                       saliency_thresholds: Sequence[float] = None,
                       method: int = 0, normalize_fn=None,
                       min_pred_value: float = 0.8,
                       keep_monotonous: bool = True,
                       num_data_points: int = 1000):
    """img: [H, W, 3] float in [0, 1]; saliency_map: [H, W].
    Returns PicResult, or 0 for the degenerate cases the reference also
    returns 0 for (:287-291)."""
    saliency_thresholds = saliency_thresholds or DEFAULT_THRESHOLDS

    def predict(arr, target, mth):
        probs = _probs(bundle, arr, normalize_fn)
        cls = int(probs.argmax())
        if target < 0:
            return float(probs[cls]), cls
        if mth == 0:
            return float(probs[target]), cls
        return float(cls == target), cls

    orig_entropy = estimate_image_entropy((img * 255).astype(np.uint8))
    fully_blurred = create_blurred_image(img, random_mask)
    blurred_entropy = estimate_image_entropy(
        (fully_blurred * 255).astype(np.uint8))

    original_pred, target = predict(img, -1, method)
    blurred_pred, _ = predict(fully_blurred, target, 0)

    if orig_entropy == blurred_entropy or original_pred == blurred_pred:
        return 0

    pairs = []
    max_norm_pred = 0.0
    for threshold in saliency_thresholds:
        q = np.quantile(saliency_map, 1 - threshold)
        mask = np.logical_or(saliency_map >= q, random_mask)
        blurred = create_blurred_image(img, mask)
        entropy = estimate_image_entropy((blurred * 255).astype(np.uint8))
        pred, _ = predict(blurred, target, method)
        ne = np.clip((entropy - blurred_entropy) /
                     (orig_entropy - blurred_entropy), 0.0, 1.0)
        npred = np.clip((pred - blurred_pred) /
                        (original_pred - blurred_pred), 0.0, 1.0)
        max_norm_pred = max(max_norm_pred, npred)
        pairs.append((ne, max_norm_pred if keep_monotonous else npred))

    pairs.append((0.0, 0.0))
    pairs.append((1.0, 1.0))
    ex, py = zip(*pairs)
    f = interpolate.interp1d(x=ex, y=py)
    cx = np.linspace(0.0, 1.0, num_data_points, endpoint=False)
    cy = np.asarray([f(v) for v in cx])
    cx = np.append(cx, 1.0)
    cy = np.append(cy, 1.0)
    return PicResult(cx, cy, float(np.trapezoid(cy, cx)))


def compute_both_metrics(bundle, img, saliency_map, random_mask,
                         saliency_thresholds: Sequence[float] = None,
                         normalize_fn=None, keep_monotonous: bool = True,
                         num_data_points: int = 1000):
    """SIC and AIC from ONE threshold sweep (PICTestFunctions.py:348-466).

    One forward per blurred image yields both the softmax value (SIC) and the
    top-1 indicator (AIC).  Reference quirk preserved: the AIC curve is
    normalized by the ORIGINAL image's softmax (getPrediction(...,-1,1) hits
    the intendedClass==-1 branch, :141-145), not by 1.0; no degenerate-case
    early return exists in this variant.
    """
    saliency_thresholds = saliency_thresholds or DEFAULT_THRESHOLDS

    def predict(arr):
        """-> (softmax probs, top1 class)."""
        probs = _probs(bundle, arr, normalize_fn)
        return probs, int(probs.argmax())

    orig_entropy = estimate_image_entropy((img * 255).astype(np.uint8))
    fully_blurred = create_blurred_image(img, random_mask)
    blurred_entropy = estimate_image_entropy(
        (fully_blurred * 255).astype(np.uint8))

    oprobs, target = predict(img)
    original_pred = float(oprobs[target])        # used by BOTH curves
    bprobs, _ = predict(fully_blurred)
    blurred_pred = float(bprobs[target])

    pairs_sic, pairs_aic = [], []
    max_np_sic = max_np_aic = 0.0
    for threshold in saliency_thresholds:
        q = np.quantile(saliency_map, 1 - threshold)
        mask = np.logical_or(saliency_map >= q, random_mask)
        blurred = create_blurred_image(img, mask)
        entropy = estimate_image_entropy((blurred * 255).astype(np.uint8))
        probs, cls = predict(blurred)
        pred_sic = float(probs[target])
        pred_aic = float(cls == target)
        ne = np.clip((entropy - blurred_entropy) /
                     (orig_entropy - blurred_entropy), 0.0, 1.0)
        np_sic = np.clip((pred_sic - blurred_pred) /
                         (original_pred - blurred_pred), 0.0, 1.0)
        np_aic = np.clip((pred_aic - blurred_pred) /
                         (original_pred - blurred_pred), 0.0, 1.0)
        max_np_sic = max(max_np_sic, np_sic)
        max_np_aic = max(max_np_aic, np_aic)
        pairs_sic.append((ne, max_np_sic if keep_monotonous else np_sic))
        pairs_aic.append((ne, max_np_aic if keep_monotonous else np_aic))

    def _curve(pairs):
        pairs = pairs + [(0.0, 0.0), (1.0, 1.0)]
        ex, py = zip(*pairs)
        f = interpolate.interp1d(x=ex, y=py)
        cx = np.linspace(0.0, 1.0, num_data_points, endpoint=False)
        cy = np.asarray([f(v) for v in cx])
        cx = np.append(cx, 1.0)
        cy = np.append(cy, 1.0)
        return PicResult(cx, cy, float(np.trapezoid(cy, cx)))

    return _curve(pairs_sic), _curve(pairs_aic)


def aggregate_individual_pic_results(results, method: str = "median"
                                     ) -> PicResult:
    """Mean/median aggregate curve over per-image PicResults
    (PICTestFunctions.py:494-532)."""
    if not results:
        raise ValueError("The list of results should have at least one "
                         "element.")
    curve_xs = np.asarray([r.curve_x for r in results])
    _, counts = np.unique(curve_xs, axis=1, return_counts=True)
    if not np.all(counts == 1):
        raise ValueError("Individual results have different x-axis data "
                         "points.")
    curve_ys = np.asarray([r.curve_y for r in results])
    if method == "mean":
        y = np.mean(curve_ys, axis=0)
    elif method == "median":
        y = np.median(curve_ys, axis=0)
    else:
        raise ValueError(f"Unknown method {method}.")
    return PicResult(curve_xs[0], y, float(np.trapezoid(y, curve_xs[0])))
