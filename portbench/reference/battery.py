"""The 10-score perturbation battery of the surveyed driver
(evaluatePerturbation.py: MAS, RISE and AIC insertion and deletion, MoRF
and LeRF responses, monotonicity), written plainly.

Three reveal passes of one image: blurred -> image by the map's
descending order (insertion), image -> zeros descending (deletion),
image -> zeros ascending (LeRF); ``step`` pixels a step, so ``ceil(H*W /
step)`` steps and one more point.  The substrate is the image under the
reference's Gaussian kernel (a delta through ``gaussian_filter``, klen 31,
sigma 31) as a zero-padded depthwise convolution; the image of step ``s``
takes the finish pixel where the pixel's flip step is ``<= s``.  The
scores are the reference's host arithmetic in NumPy float64 (a frozen
form of MASTestFunctions / RISETestFunctions / AICTestFunctions), with
SciPy's Spearman.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from scipy.ndimage import gaussian_filter
from scipy.stats import spearmanr


def gkern(klen: int, nsig: float) -> np.ndarray:
    inp = np.zeros((klen, klen))
    inp[klen // 2, klen // 2] = 1
    return gaussian_filter(inp, nsig).astype(np.float32)


def blur(x: torch.Tensor, klen: int, nsig: float) -> torch.Tensor:
    """``[N, C, H, W]`` -> the depthwise 'same' zero-padded blur."""
    c = x.shape[1]
    k = torch.as_tensor(gkern(klen, nsig), device=x.device)
    return F.conv2d(x, k.expand(c, 1, klen, klen), padding=klen // 2,
                    groups=c)


def flip_steps(saliency: np.ndarray, step: int, descending: bool
               ) -> np.ndarray:
    """``[H, W]`` -> ``[H*W]`` 1-based step at which each pixel flips, in
    ``np.argsort``'s order (reversed for descending), ties as NumPy
    breaks them."""
    flat = np.asarray(saliency).reshape(1, -1)
    order = np.argsort(flat, axis=1)
    if descending:
        order = np.flip(order, axis=-1)
    flip = np.empty(flat.shape[1], np.int64)
    flip[order[0]] = np.arange(flat.shape[1]) // step + 1
    return flip


@torch.no_grad()
def curve(forward, start, finish, flip, n_points, target, block):
    """Target probability and top-1 indicator at every point of one
    reveal pass: ``start``/``finish`` ``[C, H, W]``, ``flip`` ``[H, W]``
    on the device.  ``block`` images a forward."""
    probs, top1 = [], []
    for s0 in range(0, n_points, block):
        steps = torch.arange(s0, min(s0 + block, n_points),
                             device=start.device)
        take = flip[None, None] <= steps[:, None, None, None]
        imgs = torch.where(take, finish[None], start[None])
        logits = forward(imgs)
        probs.append(torch.softmax(logits, -1)[:, target])
        top1.append((logits.argmax(-1) == target).float())
    return (torch.cat(probs).double().cpu().numpy(),
            torch.cat(top1).double().cpu().numpy())


def auc(a) -> float:
    a = np.asarray(a, np.float64)
    return float((a.sum() - a[0] / 2 - a[-1] / 2) / (len(a) - 1))


def normalize(resp, original, baseline, deleting):
    """The response scaled between original and baseline, clipped to
    [0, 1], made monotone by a running min (deletion) or max; a NaN
    point (0 / 0) keeps the running value."""
    with np.errstate(invalid="ignore", divide="ignore"):
        v = np.clip((resp - baseline) / abs(original - baseline), 0, 1)
    out, cur = np.empty(len(v)), 1.0 if deleting else 0.0
    for i, x in enumerate(v):
        if not np.isnan(x):
            cur = min(cur, x) if deleting else max(cur, x)
        out[i] = cur
    return out


def density(saliency, flip, n_steps, deleting):
    """The share of the map's mass revealed after each step."""
    flat = np.asarray(saliency, np.float64).reshape(-1)
    per_step = np.array([flat[flip == s].sum()
                         for s in range(1, n_steps + 1)])
    with np.errstate(invalid="ignore", divide="ignore"):
        frac = np.cumsum(per_step) / flat.sum()
    return np.concatenate([[1.0], 1.0 - frac] if deleting else
                          [[0.0], frac])


def mas(norm, dens, deleting):
    """The density-penalized curve, min-max scaled; a ramp where it is
    constant."""
    pen = np.abs(norm - dens)
    c = np.clip(norm + pen if deleting else norm - pen, 0, 1)
    with np.errstate(invalid="ignore", divide="ignore"):
        c = (c - c.min()) / (c.max() - c.min())
    if np.isnan(c).any():
        c = np.linspace(1, 0, len(norm)) if deleting else \
            np.linspace(0, 1, len(norm))
    return c


def spearman(a, b) -> float:
    return float(spearmanr(a, b).correlation)


def scores(forward, x: torch.Tensor, saliency: np.ndarray, target: int,
           klen: int, nsig: float, block: int = 75) -> dict:
    """The 10 scores of one normalized image ``x`` ``[C, H, W]`` and its
    map ``[H, W]`` at ``target``; ``block`` images a forward."""
    _, h, w = x.shape
    n_steps = (h * w + h - 1) // h
    n = n_steps + 1
    desc = flip_steps(saliency, h, True)
    asc = flip_steps(saliency, h, False)
    dev = x.device
    desc_t = torch.as_tensor(desc.reshape(h, w), device=dev)
    asc_t = torch.as_tensor(asc.reshape(h, w), device=dev)
    blurred = blur(x[None], klen, nsig)[0]
    zeros = torch.zeros_like(x)
    ins_p, ins_t = curve(forward, blurred, x, desc_t, n, target, block)
    del_p, del_t = curve(forward, x, zeros, desc_t, n, target, block)
    lerf_p, _ = curve(forward, x, zeros, asc_t, n, target, block)

    rise_ins = normalize(ins_p, ins_p[-1], ins_p[0], False)
    rise_del = normalize(del_p, del_p[0], del_p[-1], True)
    return {
        "MAS_ins": auc(mas(rise_ins, density(saliency, desc, n_steps,
                                             False), False)),
        "MAS_del": auc(mas(rise_del, density(saliency, desc, n_steps,
                                             True), True)),
        "RISE_ins": auc(rise_ins),
        "RISE_del": auc(rise_del),
        "AIC_ins": auc(normalize(ins_t, ins_t[-1], ins_t[0], False)),
        "AIC_del": auc(normalize(del_t, del_t[0], del_t[-1], True)),
        "LERF_res": auc(lerf_p),
        "MORF_res": auc(del_p),
        "MONO_pos": spearman(np.linspace(0, 1, n), ins_p),
        "MONO_neg": spearman(np.linspace(1, 0, n), del_p),
    }
