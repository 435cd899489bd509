"""MAS calibration: a differentiable MAS scorer and attribution refinement
(util/attribution_methods/MASCalibrate.py:1095-1419).

Counterpart of ``xai_tpu/methods/mas_calibrate.py``.  The reference's
trick: the reveal order and the model responses are constants, while the
attribution-density curve, and with it the alignment penalty and the
min-max normalized corrected score, stay differentiable in the
attribution.  ``refine_attribution`` wraps the attribution in a 1-tensor
"network" (Net :1307-1313, whose forward is ``param + original``,
initially 2x the attribution) and Adam-optimizes ``loss = (1 - MAS_ins) +
MAS_del`` for ~25 epochs with a learning rate chosen by total
attribution mass (:1372-1384, including the non-elif first branch that
makes total < 10 resolve to 1e-4).

The responses come from ``reveal_curves`` (one reveal pass a direction an
epoch); the differentiable tail is a small torch graph that takes JAX's
subgradients at its kinks (``jax_abs``, ``jax_clip``), so that the
refinement follows xai_tpu's; the update is optax's Adam written out.
"""
from __future__ import annotations

import numpy as np
import torch

from ..metrics.curves import patch_flip_steps, pixel_flip_steps, \
    reveal_curves
from ..native import project_curve
from ..ops.blur import make_blur_fn
from ..ops.resize import resize_bilinear, resize_nearest_exact

# optax.adam's defaults
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


class _JaxAbs(torch.autograd.Function):
    """|x| with JAX's derivative: +1 at 0 (and at -0), where torch's is 0."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return x.abs()

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return torch.where(x >= 0, g, -g)


def jax_abs(x: torch.Tensor) -> torch.Tensor:
    return _JaxAbs.apply(x)


def jax_clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """``jnp.clip`` as JAX builds it, ``minimum(maximum(x, lo), hi)``: at a
    bound the tie splits the gradient evenly (0.5), where ``clamp`` passes
    all of it."""
    lo_t = torch.tensor(lo, dtype=x.dtype, device=x.device)
    hi_t = torch.tensor(hi, dtype=x.dtype, device=x.device)
    return torch.minimum(torch.maximum(x, lo_t), hi_t)


def auc(arr: torch.Tensor) -> torch.Tensor:
    """MASTestFunctions.py:30-32, the normalized trapezoid."""
    return (arr.sum() - arr[0] / 2 - arr[-1] / 2) / (arr.shape[0] - 1)


def _normalize_response(resp, original, base, mode):
    """MASCalibrate.MAS:1252-1266 (NO abs in the denominator)."""
    out = resp.copy()
    mn, mx = 1.0, 0.0
    for i in range(len(out)):
        v = np.clip((out[i] - base) / (original - base), 0.0, 1.0)
        if mode == "del":
            mn = min(mn, v)
            out[i] = mn
        else:
            mx = max(mx, v)
            out[i] = mx
    return out


def _special_normalize(resp, mode):
    """The special_version derivative normalization (:1212-1250)."""
    deriv = np.diff(np.concatenate([[1.0], resp]))
    deriv[0] = deriv[1]
    if mode == "del":
        deriv = -deriv
    new = np.zeros_like(deriv)
    mn = 1.0
    for i in range(len(deriv)):
        v = (deriv[i] - deriv[-1]) / (deriv[0] - deriv[-1])
        if v > 1:
            c = mn
        elif v < 0:
            c = deriv[i - 1]
        else:
            c = v
        mn = min(mn, c)
        new[i] = mn
    deriv = new
    if mode == "del":
        deriv = -deriv
    resp = np.cumsum(deriv)
    return (resp - resp.min()) / (resp.max() - resp.min())


def _hwc(x, device) -> torch.Tensor:
    """A float32 tensor on ``device`` of a numpy array or a tensor."""
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.asarray(x))
    return x.to(device=device, dtype=torch.float32)


@torch.no_grad()
def _prep(bundle, x, sal2d, mode, segments=None, segment_order=None,
          blur_fn=None, chunk=25, special_version=False, total_steps=None):
    """Non-differentiable prep: flip schedule + normalized responses.
    x: ``[H, W, C]`` (numpy or a tensor); sal2d: ``[H, W]`` numpy."""
    h = x.shape[0]
    n_px_steps = total_steps or h
    if segments is None:
        flip = pixel_flip_steps(sal2d, int(h * h / n_px_steps))
        n_steps = n_px_steps
    else:
        if segment_order is None:
            flip = patch_flip_steps(sal2d, segments)
        else:
            seg_step = np.empty(int(segments.max()) + 1, np.int32)
            seg_step[np.asarray(segment_order, int)] = \
                np.arange(len(segment_order)) + 1
            flip = seg_step[np.asarray(segments).reshape(-1)]
        n_steps = int(np.asarray(segments).max()) + 1

    blur_fn = blur_fn or make_blur_fn(31, 31.0)
    xt = _hwc(x, bundle.device)
    xb = xt.permute(2, 0, 1)[None].contiguous()
    if mode == "del":
        start, finish = xt, torch.zeros_like(xt)
    else:
        start, finish = blur_fn(xb)[0].permute(1, 2, 0), xt
    target = int(bundle.apply(xb)[0].argmax())
    out = reveal_curves(bundle.apply, start, finish, flip, n_steps, target,
                        chunk=chunk,
                        original_at="start" if mode == "del" else "finish")
    if special_version:
        resp = _special_normalize(out.target_prob, mode)
    else:
        resp = _normalize_response(out.target_prob, out.original_pred,
                                   out.baseline_pred, mode)
    return flip, resp, n_steps


def differentiable_mas(attr_3c: torch.Tensor, flip, resp_norm, n_steps,
                       mode):
    """The differentiable tail: density from the attribution, penalty,
    minmax, AUC; ``attr_3c`` (``[H, W, 3]``) may require grad, everything
    else is constant.  float32, with JAX's subgradients at |0| and at the
    clip's bounds; a tie in min or max splits evenly in both packages.
    Returns (score, penalty AUC) tensors."""
    dev = attr_3c.device
    sal = jax_abs(attr_3c.sum(-1)).reshape(-1)
    total = sal.sum()
    idx = torch.as_tensor(np.asarray(flip), dtype=torch.int64, device=dev)
    per_step = torch.zeros(n_steps + 1, dtype=sal.dtype, device=dev) \
        .index_add_(0, idx, sal)[1:]
    frac = torch.cumsum(per_step, 0) / total
    if mode == "del":
        dens = torch.cat([torch.ones(1, dtype=sal.dtype, device=dev),
                          1.0 - frac])
    else:
        dens = torch.cat([torch.zeros(1, dtype=sal.dtype, device=dev), frac])
    resp = torch.as_tensor(np.asarray(resp_norm), dtype=sal.dtype,
                           device=dev)
    penalty = jax_abs(resp - dens)
    corrected = resp + penalty if mode == "del" else resp - penalty
    corrected = jax_clip(corrected, 0.0, 1.0)
    corrected = (corrected - corrected.amin()) / \
        (corrected.amax() - corrected.amin())
    return auc(corrected), auc(penalty)


def mas_score(bundle, x, attr_3c, mode, segments=None, segment_order=None,
              special_version=False, blur_fn=None):
    """MASCalibrate.MAS equivalent returning (score, penalty) floats."""
    attr = np.asarray(attr_3c)
    sal2d = np.abs(attr.sum(-1))
    flip, resp, n_steps = _prep(bundle, x, sal2d, mode, segments,
                                segment_order, blur_fn,
                                special_version=special_version)
    with torch.no_grad():
        s, p = differentiable_mas(_hwc(attr, bundle.device), flip, resp,
                                  n_steps, mode)
    return float(s), float(p)


def heuristic_lr(attr_3c) -> float:
    total = float(np.abs(np.asarray(attr_3c).sum(-1)).sum())
    lr = 0.1
    if total < 10:
        lr = 0.00001
    if total < 500:
        lr = 0.0001
    elif total < 1000:
        lr = 0.001
    elif total < 10000:
        lr = 0.01
    return lr


def mas_response(bundle, x, attr_3c, mode, segments=None,
                 special_version=False, blur_fn=None, total_steps=None):
    """The MAS preprocess=1 path (MASCalibrate.py:1286-1287): just the
    normalized model response."""
    sal2d = np.abs(np.asarray(attr_3c).sum(-1))
    _, resp, _ = _prep(bundle, x, sal2d, mode, segments, None, blur_fn,
                       special_version=special_version,
                       total_steps=total_steps)
    return resp


def calibrate_density(bundle, x, attr_3c, total_steps=None, mode="del",
                      blur_fn=None, special_version=False):
    """calibrate_density (MASCalibrate.py:985-1050): QP-project the
    normalized response, then rebuild a map whose per-step density equals
    the projected response derivative along the salient order."""
    h = x.shape[0]
    total_steps = total_steps or h
    step_size = int(h * h / total_steps)
    n_steps = (h * h + step_size - 1) // step_size
    resp = mas_response(bundle, x, attr_3c, mode, blur_fn=blur_fn,
                        special_version=special_version,
                        total_steps=total_steps)
    resp = project_curve(np.asarray(resp, np.float64), mode)

    sal2d = np.abs(np.asarray(attr_3c).sum(-1))
    flat = sal2d.reshape(-1)
    order = np.flip(np.argsort(flat.reshape(1, -1), axis=1), axis=-1)[0]
    new_map = np.zeros(h * h)
    for i in range(1, n_steps + 1):
        if mode == "del":
            t = resp[i - 1] - resp[i]
        else:
            t = resp[i] - resp[i - 1]
        coords = order[step_size * (i - 1): step_size * i]
        # NO division: the reference divides by len(coords) where coords is
        # a [1, step_size] tensor, so len() is 1 (MASCalibrate.py:1044)
        new_map[coords] = t
    return np.repeat(new_map.reshape(h, h, 1), 3, axis=2)


def remove_pixels(bundle, x, attr_3c, total_steps=None, mode="del",
                  segments=None, blur_fn=None, special_version=False):
    """remove_pixels (MASCalibrate.py:1051-1094): zero the attribution in
    the reveal-order tail where the response derivative is already 0."""
    h = x.shape[0]
    total_steps = total_steps or h
    resp = np.asarray(mas_response(
        bundle, x, attr_3c, mode, segments, special_version, blur_fn,
        total_steps=None if segments is not None else total_steps))
    if mode == "del":
        deriv = np.abs(np.diff(np.insert(resp, 0, 1.0)))
    else:
        deriv = np.abs(np.diff(np.insert(resp, 1, 0.0)))

    sal2d = np.abs(np.asarray(attr_3c).sum(-1))
    flat = sal2d.reshape(-1).copy()
    nz = np.where(deriv != 0)[0]
    start_step = nz[-1] if len(nz) else 0
    if segments is None:
        step_size = int(h * h / total_steps)
        n_steps = (h * h + step_size - 1) // step_size
        order = np.flip(np.argsort(flat.reshape(1, -1), axis=1), axis=-1)[0]
        # reference quirk (MASCalibrate.py:1084-1088): the (i-1) slice is
        # shifted one step EARLY — step start_step's own block is zeroed
        # while the final block survives — reproduced deliberately
        for i in range(int(start_step), n_steps):
            coords = order[step_size * (i - 1): step_size * i]
            flat[coords] = 0.0
    else:
        seg = np.asarray(segments).reshape(-1)
        n_steps = int(seg.max()) + 1
        means = np.bincount(seg, weights=flat, minlength=n_steps) / \
            np.maximum(np.bincount(seg, minlength=n_steps), 1)
        order = np.flip(np.argsort(means))
        for i in range(int(start_step), n_steps):
            flat[seg == order[i - 1]] = 0.0
    return np.repeat(flat.reshape(h, h, 1), 3, axis=2)


def _smooth(attr: np.ndarray, h: int, device) -> np.ndarray:
    """NEAREST_EXACT downsize to 7 x 7, bilinear back (``[H, W, 3]``)."""
    chw = _hwc(attr, device).permute(2, 0, 1)
    down = resize_nearest_exact(chw, (7, 7))
    return resize_bilinear(down, (h, h)).permute(1, 2, 0).cpu().numpy()


class Adam:
    """optax.adam(lr) on one tensor, written out: moments with b1 0.9 and
    b2 0.999, bias correction, eps 1e-8 outside the square root."""

    def __init__(self, lr: float, like: torch.Tensor):
        self.lr = lr
        self.mu = torch.zeros_like(like)
        self.nu = torch.zeros_like(like)
        self.count = 0

    def step(self, param: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
        self.mu = (1 - ADAM_B1) * g + ADAM_B1 * self.mu
        self.nu = (1 - ADAM_B2) * (g * g) + ADAM_B2 * self.nu
        self.count += 1
        f32 = dict(dtype=g.dtype, device=g.device)
        mu_hat = self.mu / (1 - torch.tensor(ADAM_B1, **f32) ** self.count)
        nu_hat = self.nu / (1 - torch.tensor(ADAM_B2, **f32) ** self.count)
        return param + (-self.lr) * (mu_hat / (torch.sqrt(nu_hat)
                                               + ADAM_EPS))


def refine_attribution(bundle, x, saliency_3c, lr=None, smoothing=False,
                       epochs: int = 25, segments=None, segment_order=None,
                       special_version=False, blur_fn=None):
    """MASCalibrator.refine_attribution (:1333-1420).  x: ``[H, W, C]``
    normalized input; saliency_3c: ``[H, W, 3]``.  Returns the refined map
    (and the smoothed variant when segments are given), numpy."""
    dev = bundle.device
    h = x.shape[0]
    attr = np.asarray(saliency_3c, np.float32)
    if smoothing:
        attr = _smooth(attr, h, dev)
    if segments is not None:
        seg = np.asarray(segments).reshape(-1)
        sal = np.abs(attr.sum(-1)).reshape(-1)
        n = int(seg.max()) + 1
        means = np.bincount(seg, weights=sal, minlength=n) / \
            np.maximum(np.bincount(seg, minlength=n), 1)
        sal = means[seg]
        attr = np.repeat(sal.reshape(h, h, 1), 3, axis=2).astype(np.float32)

    lr = lr if lr is not None else heuristic_lr(attr)
    attr_orig = _hwc(attr, dev)
    param = attr_orig.clone()                       # Net: param + original
    opt = Adam(lr, param)

    ins, _ = mas_score(bundle, x, attr, "ins", segments, segment_order,
                       special_version, blur_fn)
    dele, _ = mas_score(bundle, x, attr, "del", segments, segment_order,
                        special_version, blur_fn)
    best_loss = (1 - ins) + dele
    best_attr = attr_orig

    for _ in range(epochs):
        output = param + attr_orig
        sal2d = np.abs(output.sum(-1).cpu().numpy())
        flip_i, resp_i, n_i = _prep(bundle, x, sal2d, "ins", segments,
                                    segment_order, blur_fn,
                                    special_version=special_version)
        flip_d, resp_d, n_d = _prep(bundle, x, sal2d, "del", segments,
                                    segment_order, blur_fn,
                                    special_version=special_version)
        p = param.clone().requires_grad_(True)
        with torch.enable_grad():
            out = p + attr_orig
            s_i, _ = differentiable_mas(out, flip_i, resp_i, n_i, "ins")
            s_d, _ = differentiable_mas(out, flip_d, resp_d, n_d, "del")
            loss = (1.0 - s_i) + s_d
            (g,) = torch.autograd.grad(loss, p)
        loss = float(loss.detach())
        if loss < best_loss:
            best_loss = loss
            best_attr = output
        param = opt.step(param, g)

    best = best_attr.cpu().numpy()
    if segments is None:
        return best
    return best, _smooth(best, h, dev)
