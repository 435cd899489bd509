"""Segmentation-as-attribution metrics (XAI_Survey/evaluations/utils/
metrices.py + evaluateImageNetSeg.py): pixel accuracy, intersection/union,
average precision, F1.

Counterpart of ``xai_tpu/metrics/seg.py``, in host numpy.  xai_tpu takes
average precision and F1 from scikit-learn; here they are written out,
to scikit-learn's definitions, so the port needs no scikit-learn:

- average precision is ``average_precision_score``'s sum over the
  distinct score thresholds, in descending order with tied scores
  grouped, of (R_n - R_{n-1}) * P_n (R_{-1} = 0); with no positive label
  recall is 1 at every threshold, as scikit-learn sets it;
- binary F1 is 2 TP / (2 TP + FP + FN), 0 where that is 0 / 0 (the
  value of scikit-learn's ``zero_division`` default).

The driver's protocol (evaluateImageNetSeg.py:216-221, 470-505): the
attribution is minmax-normalized, thresholded at its mean to a binary
fg/bg prediction; metrics accumulate over the Imagenet_Segmentation set.
"""
from __future__ import annotations

import numpy as np


def batch_pix_accuracy(predict_2class: np.ndarray, target: np.ndarray):
    """predict_2class: [2, H, W] scores (bg, fg); target: [H, W] in {0,1}.
    Returns (pixel_correct, pixel_labeled) — metrices.py:136-158."""
    pred = np.argmax(predict_2class, axis=0)
    pixel_labeled = np.sum(target > 0)
    pixel_correct = np.sum((pred == target) * (target > 0))
    return pixel_correct, pixel_labeled


def batch_intersection_union(predict_2class: np.ndarray, target: np.ndarray,
                             nclass: int = 2):
    """metrices.py:161-185."""
    pred = np.argmax(predict_2class, axis=0) + 1
    target = np.asarray(target) + 1
    pred = pred * (target > 0).astype(pred.dtype)
    intersection = pred * (pred == target)
    area_inter, _ = np.histogram(intersection, bins=nclass,
                                 range=(1, nclass))
    area_pred, _ = np.histogram(pred, bins=nclass, range=(1, nclass))
    area_lab, _ = np.histogram(target, bins=nclass, range=(1, nclass))
    area_union = area_pred + area_lab - area_inter
    return area_inter, area_union


def average_precision(y_true: np.ndarray, y_score: np.ndarray) -> float:
    """scikit-learn's ``average_precision_score`` of binary labels."""
    y = np.asarray(y_true).ravel() == 1
    s = np.asarray(y_score, np.float64).ravel()
    order = np.argsort(s, kind="mergesort")[::-1]
    s, y = s[order], y[order]
    # the last index of each run of tied scores, descending
    last = np.r_[np.flatnonzero(np.diff(s)), s.size - 1]
    tps = np.cumsum(y)[last].astype(np.float64)
    precision = tps / (last + 1)
    recall = (np.ones_like(tps) if tps[-1] == 0 else tps / tps[-1])
    return max(0.0, float(np.sum(np.diff(np.r_[0.0, recall]) * precision)))


def f1_binary(y_true: np.ndarray, y_pred: np.ndarray) -> float:
    """scikit-learn's ``f1_score`` of binary labels (positive label 1)."""
    t = np.asarray(y_true).ravel() == 1
    p = np.asarray(y_pred).ravel() == 1
    tp = np.count_nonzero(t & p)
    denom = 2 * tp + np.count_nonzero(~t & p) + np.count_nonzero(t & ~p)
    return 0.0 if denom == 0 else 2.0 * tp / denom


def get_ap_scores(predict_2class: np.ndarray, target: np.ndarray):
    """metrices.py:82-101 for one (pred, target) pair: AP over the flattened
    one-hot target vs the [2, H, W] scores."""
    t = np.asarray(target).astype(int)
    one_hot = np.stack([(t == 0), (t == 1)]).astype(float)
    return [float(np.nan_to_num(average_precision(
        one_hot.ravel(), np.asarray(predict_2class).ravel())))]


def get_f1_scores(predict_fg: np.ndarray, target: np.ndarray):
    """metrices.py:26-39 for one pair: binary F1 of the thresholded map."""
    p = np.asarray(predict_fg).astype(np.int8).ravel()
    t = np.asarray(target).astype(int).ravel()
    return [float(np.nan_to_num(f1_binary(t, p)))]


MAG_VALS = np.array([0.4, 0.45, 0.5, 0.55, 0.6, 0.65, 0.7, 0.75,
                     0.8, 0.85, 0.9, 0.95])


def best_threshold(saliency: np.ndarray, gt_mask: np.ndarray):
    """The MDA_dense / Calibrate_Best_Possible per-image threshold sweep
    (evaluateImageNetSeg.py:331-360, imagenet_seg_eval.py:194-222):
    minmax-normalize, rescale to mean 0.5, then pick the MAG_VALS threshold
    maximizing IoU.  Returns (rescaled saliency, chosen threshold)."""
    sal = np.asarray(saliency, np.float64)
    sal = (sal - sal.min()) / max(sal.max() - sal.min(), 1e-12)
    sal = sal / max(sal.mean(), 1e-12) * 0.5
    ious = np.zeros(len(MAG_VALS))
    for i, m in enumerate(MAG_VALS):
        fg = (sal > m).astype(np.float64)
        bg = (sal <= m).astype(np.float64)
        inter, union = batch_intersection_union(np.stack([bg, fg]), gt_mask)
        ious[i] = np.mean(inter / (np.spacing(1) + union))
    return sal, float(MAG_VALS[int(np.argmax(ious))])


def eval_batch(saliency: np.ndarray, gt_mask: np.ndarray,
               thr: float | None = None, normalized: bool = False):
    """The seg driver's per-image evaluation (evaluateImageNetSeg.py:470-505):
    minmax-normalize, threshold at the mean (or a caller-fixed ``thr``),
    build the 2-channel score map, return the four accumulator tuples.
    ``normalized=True`` skips the minmax (the best_threshold path already
    rescaled the map to match its chosen threshold)."""
    sal = np.asarray(saliency, np.float64)
    if not normalized:
        sal = (sal - sal.min()) / max(sal.max() - sal.min(), 1e-12)
    if thr is None:
        thr = sal.mean()
    fg = (sal > thr).astype(np.float64)
    bg = (sal <= thr).astype(np.float64)
    # the reference feeds the BINARY (Res_0, Res_1) channels to pixAcc, IoU
    # AND AP (evaluateImageNetSeg.py:472-503)
    hard_2 = np.stack([bg, fg])
    correct, labeled = batch_pix_accuracy(hard_2, gt_mask)
    inter, union = batch_intersection_union(hard_2, gt_mask)
    ap = get_ap_scores(hard_2, gt_mask)
    f1 = get_f1_scores(fg, gt_mask)
    return correct, labeled, inter, union, ap, f1
