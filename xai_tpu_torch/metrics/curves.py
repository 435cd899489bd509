"""The ranked-reveal curve engine and the 10-score perturbation battery.

Counterpart of ``xai_tpu/metrics/curves.py``.  Every perturbation metric
of the reference (MAS / RISE / AIC / MoRF-LeRF / Monotonicity) shares one
inner loop: rank pixels by saliency, swap ``step_size`` pixels per step
from a start image to a finish image, and record the model's softmax
response at each step.  The schedule is a per-pixel int, "the step at
which this pixel flips", so the image at step ``s`` is ``where(flip <= s,
finish, start)``: the reveal kernel (``kernels/reveal.py``) writes a chunk
of those images straight into one batched forward.  One pass returns
target prob, top-1 indicator and entropy, so the 8-metric battery costs 3
passes (blur/ins, zeros/del, zeros/lerf) instead of 8.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..kernels.reveal import reveal_chunk
from ..ops.stats import auc_np, entropy_bits, spearman_np


# ---------------------------------------------------------------------------
# reveal schedules
# ---------------------------------------------------------------------------

def pixel_flip_steps(saliency: np.ndarray, step_size: int,
                     descending: bool = True) -> np.ndarray:
    """[H, W] saliency -> [H*W] int32 'flip step' (1-indexed).

    Matches np.flip(np.argsort(...)) ordering incl. its tie behaviour
    (MASTestFunctions.py:207-212), so it stays numpy: torch.argsort breaks
    ties differently, and the tie order is part of the result.
    """
    flat = np.asarray(saliency).reshape(-1)
    hw = flat.shape[0]
    if descending:
        order = np.flip(np.argsort(flat.reshape(1, hw), axis=1), axis=-1)[0]
    else:
        order = np.argsort(flat.reshape(1, hw), axis=1)[0]
    flip = np.empty(hw, dtype=np.int32)
    flip[order] = np.arange(hw, dtype=np.int32) // step_size + 1
    return flip


# ---------------------------------------------------------------------------
# the device engine
# ---------------------------------------------------------------------------

def _curves_core(apply_fn, start, finish, flip, n_steps: int, chunk: int,
                 target: int):
    """start/finish: [C, H, W]; flip: [H, W] int32, all on one device.

    Returns target prob, top-1 indicator and entropy at steps 0..n_steps.
    When ``chunk`` does not divide the step count the last chunk is
    ragged: PyTorch needs no static shapes, so it runs only the steps that
    exist (xai_tpu pads to a whole chunk)."""
    total = n_steps + 1
    tp, top1, ent = [], [], []
    for s0 in range(0, total, chunk):
        steps = torch.arange(s0, min(s0 + chunk, total), dtype=torch.int32,
                             device=start.device)
        logits = apply_fn(reveal_chunk(start, finish, flip, steps))
        p = torch.softmax(logits, dim=-1)
        tp.append(p[:, target])
        top1.append((logits.argmax(dim=-1) == target).to(p.dtype))
        ent.append(entropy_bits(p))
    return torch.cat(tp), torch.cat(top1), torch.cat(ent)


@torch.inference_mode()
def _battery(apply_fn, blur_fn, x, desc, asc, n_steps: int, chunk: int,
             target: int):
    """The battery's device work: blur substrate, target selection (argmax
    when target < 0), and the three reveal passes.  x: [C, H, W];
    desc/asc: [H, W] int32 flip steps."""
    blurred = blur_fn(x[None])[0]
    zeros = torch.zeros_like(x)
    t = int(apply_fn(x[None])[0].argmax()) if target < 0 else target
    ins = _curves_core(apply_fn, blurred, x, desc, n_steps, chunk, t)
    dele = _curves_core(apply_fn, x, zeros, desc, n_steps, chunk, t)
    lerf = _curves_core(apply_fn, x, zeros, asc, n_steps, chunk, t)
    return ins, dele, lerf, t


# ---------------------------------------------------------------------------
# metric post-processing (all O(n_steps) — host numpy, matching reference
# float semantics exactly)
# ---------------------------------------------------------------------------

def monotone_normalize(response: np.ndarray, original_pred: float,
                       baseline_pred: float, mode: str) -> np.ndarray:
    """MASTestFunctions.py:297-309 — normalize against (original, baseline)
    and enforce monotonicity with a running min (del) / max (ins).

    NaN entries (degenerate baseline == original, e.g. AIC's 0/0) replicate
    the reference's Python ``min(mn, nan) -> mn`` semantics: they leave the
    running value unchanged (initial value 1.0 for del, 0.0 for ins).
    """
    denom = abs(original_pred - baseline_pred)
    with np.errstate(invalid="ignore", divide="ignore"):
        norm = np.clip((response - baseline_pred) / denom, 0.0, 1.0)
    nan = np.isnan(norm)
    if mode in ("del", "morf", "lerf"):
        v = np.where(nan, np.inf, norm)
        return np.minimum.accumulate(np.concatenate([[1.0], v]))[1:]
    v = np.where(nan, -np.inf, norm)
    return np.maximum.accumulate(np.concatenate([[0.0], v]))[1:]


def density_response(saliency: np.ndarray, flip_step: np.ndarray,
                     n_steps: int, mode: str) -> np.ndarray:
    """MAS attribution-density curve (MASTestFunctions.py:225-263)."""
    flat = np.asarray(saliency).reshape(-1).astype(np.float64)
    total = flat.sum()
    per_step = np.bincount(flip_step, weights=flat,
                           minlength=n_steps + 1)[1:n_steps + 1]
    # an all-zero map is 0/0 here; mas_scores' NaN-ramp fallback handles
    # it exactly as the reference does
    with np.errstate(invalid="ignore", divide="ignore"):
        frac = np.cumsum(per_step) / total
    if mode in ("del", "morf", "lerf"):
        return np.concatenate([[1.0], 1.0 - frac])
    return np.concatenate([[0.0], frac])


def mas_scores(normalized: np.ndarray, density: np.ndarray,
               mode: str) -> np.ndarray:
    """Density-alignment correction + minmax (MASTestFunctions.py:352-368)."""
    penalty = np.abs(normalized - density)
    if mode in ("del", "morf", "lerf"):
        corrected = normalized + penalty
    else:
        corrected = normalized - penalty
    corrected = corrected.clip(0, 1)
    rng = corrected.max() - corrected.min()
    with np.errstate(invalid="ignore", divide="ignore"):
        corrected = (corrected - corrected.min()) / rng
    if np.isnan(corrected).any():
        n = len(normalized)
        if mode in ("del", "morf"):
            corrected = np.linspace(1, 0, n)
        else:
            corrected = np.linspace(0, 1, n)
    return corrected


def assemble_battery_scores(ins_tp, ins_t1, del_tp, del_t1, lerf_tp,
                            saliency, desc, n_steps: int) -> dict:
    """The 10-score assembly over the three reveal curves.

    Endpoint conventions (evaluatePerturbation.py:448-495): the insertion
    curve ENDS at the clean image and starts at the substrate; the deletion
    curve STARTS at the clean image.  AIC anchors come off the top-1
    indicator's own endpoints."""
    ins_tp = np.asarray(ins_tp)
    ins_t1 = np.asarray(ins_t1)
    del_tp = np.asarray(del_tp)
    del_t1 = np.asarray(del_t1)
    lerf_tp = np.asarray(lerf_tp)

    # --- MAS ins/del (blur-ins, zeros-del; MASTestFunctions) ---
    rise_ins = monotone_normalize(ins_tp, float(ins_tp[-1]),
                                  float(ins_tp[0]), "ins")
    rise_del = monotone_normalize(del_tp, float(del_tp[0]),
                                  float(del_tp[-1]), "del")
    dens_ins = density_response(saliency, desc, n_steps, "ins")
    dens_del = density_response(saliency, desc, n_steps, "del")

    # --- AIC ins/del (top-1-preserved binary response; AICTestFunctions) ---
    aic_ins = monotone_normalize(ins_t1, float(ins_t1[-1]),
                                 float(ins_t1[0]), "ins")
    aic_del = monotone_normalize(del_t1, float(del_t1[0]),
                                 float(del_t1[-1]), "del")

    return {
        "MAS_ins": float(auc_np(mas_scores(rise_ins, dens_ins, "ins"))),
        "MAS_del": float(auc_np(mas_scores(rise_del, dens_del, "del"))),
        "RISE_ins": float(auc_np(rise_ins)),
        "RISE_del": float(auc_np(rise_del)),
        "AIC_ins": float(auc_np(aic_ins)),
        "AIC_del": float(auc_np(aic_del)),
        # --- MoRF/LeRF raw responses (PosNegPertFunctions returns raw) ---
        "LERF_res": float(auc_np(lerf_tp)),
        "MORF_res": float(auc_np(del_tp)),
        # --- Monotonicity (raw response vs ideal ramp; MonotonicityTest) ---
        "MONO_pos": float(spearman_np(np.linspace(0, 1, n_steps + 1),
                                      ins_tp)),
        "MONO_neg": float(spearman_np(np.linspace(1, 0, n_steps + 1),
                                      del_tp)),
    }


# ---------------------------------------------------------------------------
# the full battery — evaluatePerturbation.run_perturbation equivalent
# ---------------------------------------------------------------------------

def run_battery(apply_fn, input_img: torch.Tensor, saliency: np.ndarray,
                blur_fn, step_size: Optional[int] = None, chunk: int = 45,
                target: Optional[int] = None) -> dict:
    """Compute all 10 perturbation scores for one image.

    apply_fn: NCHW batch -> logits (``bundle.apply``).  input_img:
    [H, W, C] normalized input on the model's device.  saliency: [H, W].
    Returns the reference's Counter keys (evaluatePerturbation.py:484-495)
    -> float score.
    """
    H, W, C = input_img.shape
    hw = H * W
    step_size = step_size or H
    n_steps = (hw + step_size - 1) // step_size

    desc = pixel_flip_steps(saliency, step_size, descending=True)
    asc = pixel_flip_steps(saliency, step_size, descending=False)
    dev = input_img.device
    x = input_img.permute(2, 0, 1).contiguous()
    ins, dele, lerf, _ = _battery(
        apply_fn, blur_fn, x, torch.from_numpy(desc.reshape(H, W)).to(dev),
        torch.from_numpy(asc.reshape(H, W)).to(dev), n_steps, chunk,
        -1 if target is None else int(target))
    # one device -> host copy for the five curves the scores read
    ins_tp, ins_t1, del_tp, del_t1, lerf_tp = torch.stack(
        [ins[0], ins[1], dele[0], dele[1], lerf[0]]).cpu().numpy()
    return assemble_battery_scores(ins_tp, ins_t1, del_tp, del_t1, lerf_tp,
                                   saliency, desc, n_steps)
