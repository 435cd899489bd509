"""MAC, the Magnitude Aligned Cleaning denoiser
(util/attribution_methods/MACBuilder.py).

Counterpart of ``xai_tpu/methods/mac.py``.  ``retrieve_maf`` computes
per-segment Magnitude Alignment Factors from the ratio of the
|model-response derivative| to the attribution-density derivative over a
segment-ranked reveal (MACBuilder.py:37-231); ``clean_attribution``
rescales segments by (1 + MAF) until the MAS score stagnates or worsens
``cutoff`` times (:269-362).  Segments default to Felzenszwalb(scale=0,
sigma=0.01, min_size=img_hw) (:290).  Every reveal pass is one
``reveal_curves`` call (the reveal kernel on the card); the substrate is
the blur (the blur kernel).
"""
from __future__ import annotations

import numpy as np
import torch

from ..metrics.curves import (density_response, mas_scores,
                              monotone_normalize, patch_flip_steps,
                              pixel_flip_steps, reveal_curves)
from ..native import felzenszwalb
from ..ops.blur import make_blur_fn
from ..ops.stats import auc_np
from .mas_calibrate import _hwc, _normalize_response


@torch.no_grad()
def _endpoints(bundle, x, mode, blur_fn):
    """(image, start, finish, target): MAC deletes TO THE SUBSTRATE, not to
    zeros (MACBuilder.py:88-90, 304)."""
    xt = _hwc(x, bundle.device)
    xb = xt.permute(2, 0, 1)[None].contiguous()
    sub = blur_fn(xb)[0].permute(1, 2, 0)
    start, finish = (xt, sub) if mode == "del" else (sub, xt)
    return start, finish, int(bundle.apply(xb)[0].argmax())


def _segment_reveal(bundle, x, sal2d, segments, mode, blur_fn, chunk=25):
    flip = patch_flip_steps(sal2d, segments)
    n_steps = int(np.asarray(segments).max()) + 1
    start, finish, target = _endpoints(bundle, x, mode, blur_fn)
    out = reveal_curves(bundle.apply, start, finish, flip, n_steps, target,
                        chunk=chunk,
                        original_at="start" if mode == "del" else "finish")
    return flip, out, n_steps


def retrieve_maf(bundle, x, sal2d, segments, mode, blur_fn, chunk=25):
    """(MAF, segment_order, corrected_scores): MACBuilder.py:56-231."""
    segments = np.asarray(segments)
    n = int(segments.max()) + 1
    seg_flat = segments.reshape(-1)
    sal_flat = np.asarray(sal2d).reshape(-1)
    seg_sal = np.bincount(seg_flat, weights=sal_flat, minlength=n) / \
        np.maximum(np.bincount(seg_flat, minlength=n), 1)
    segment_order = np.flip(np.argsort(seg_sal), axis=-1)

    flip, out, n_steps = _segment_reveal(bundle, x, sal2d, segments, mode,
                                         blur_fn, chunk)
    # density derivative per step (attr fraction flipped at that step)
    total = sal_flat.sum()
    per_step = np.bincount(flip, weights=sal_flat,
                           minlength=n_steps + 1)[1:]
    dens_deriv = np.concatenate([per_step / total, [0.0]])

    # the same MASCalibrate.py:1252-1266 loop as mas_calibrate's
    norm = _normalize_response(np.asarray(out.target_prob, np.float64),
                               out.original_pred, out.baseline_pred, mode)
    dens = density_response(sal2d, flip, n_steps, mode)
    corrected = mas_scores(norm, dens, mode)

    deriv = np.gradient(norm, 1)
    deriv_abs = np.abs(deriv)
    deriv_error = np.abs(deriv_abs - dens_deriv)
    maf = np.divide(deriv_abs, dens_deriv, out=deriv_abs.copy(),
                    where=dens_deriv != 0)
    maf[deriv_error <= 0] = 0
    return maf, segment_order, corrected


def clean_attribution(bundle, trans_img, x, saliency_3c, iterations: int,
                      mode: str = "ins", blur_fn=None, segments=None,
                      cutoff: int = 5, chunk: int = 25):
    """Denoise.clean_attribution (:269-362).  x: ``[H, W, C]`` normalized
    input; saliency_3c: ``[H, W, 3]``.  Returns (best_map, iterations,
    summary string)."""
    blur_fn = blur_fn or make_blur_fn(31, 31.0)
    h = x.shape[0]
    new_map = np.asarray(saliency_3c, np.float64)
    maps = [new_map]
    scores = []
    best_score = 1.0 if mode == "del" else 0.0
    best_index = 0
    stagnant = 0
    worse = 0

    if segments is None:
        segments = felzenszwalb(np.asarray(trans_img, np.float32),
                                scale=0.0, sigma=0.01, min_size=h)
    seg_flat = np.asarray(segments).reshape(-1)
    start, finish, target = _endpoints(bundle, x, mode, blur_fn)

    i = 0
    while i <= iterations:
        sal2d = np.abs(new_map.sum(-1))
        # scored by the pixel-ranked MAS metric (MACBuilder.py:303-314),
        # whose substrate is the blur too
        flip = pixel_flip_steps(sal2d, h)
        out = reveal_curves(bundle.apply, start, finish, flip, h, target,
                            chunk=chunk,
                            original_at="start" if mode == "del"
                            else "finish")
        norm = monotone_normalize(out.target_prob, out.original_pred,
                                  out.baseline_pred, mode)
        dens = density_response(sal2d, flip, h, mode)
        score = auc_np(mas_scores(norm, dens, mode))

        if mode == "del":
            if score < best_score:
                best_score, best_index, worse = score, i, 0
            elif score > best_score:
                worse += 1
        else:
            if score > best_score:
                best_score, best_index, worse = score, i, 0
            elif score < best_score:
                worse += 1
        if i > 1 and round(score, 3) == round(scores[i - 1], 3):
            stagnant += 1
        elif i > 1:
            stagnant = 0
        scores.append(score)
        if stagnant == cutoff or worse == cutoff or i == iterations:
            break

        maf, segment_order, _ = retrieve_maf(bundle, x, sal2d, segments,
                                             mode, blur_fn, chunk)
        modifier = np.ones(h * h)
        for j, s in enumerate(segment_order):
            m = seg_flat == s
            modifier[m] += modifier[m] * maf[j]
        new_map = new_map * modifier.reshape(h, h, 1)
        maps.append(new_map)
        i += 1

    summary = (f"start: {round(scores[0], 3)} best: "
               f"{round(scores[best_index], 3)}")
    return maps[best_index], i, summary
