"""The ranked-reveal curve engine and the 10-score perturbation battery.

Counterpart of ``xai_tpu/metrics/curves.py``.  Every perturbation metric
of the reference (MAS / RISE / AIC / MoRF-LeRF / Monotonicity) shares one
inner loop: rank pixels by saliency, swap ``step_size`` pixels per step
from a start image to a finish image, and record the model's softmax
response at each step.  The schedule is a per-pixel int, "the step at
which this pixel flips", so the image at step ``s`` is ``where(flip <= s,
finish, start)``: the reveal kernel (``kernels/reveal.py``) writes a chunk
of those images, for every image of a batch, straight into one batched
forward.  One pass returns target prob, top-1 indicator and entropy, so
the 8-metric battery costs 3 passes (blur/ins, zeros/del, zeros/lerf)
instead of 8, run together (:func:`_battery`).  One host flow
(:func:`_battery_over_shards`) drives every battery: the per-image one
is a batch of one on one device, and the mesh's
(``parallel/sharded_battery.py``) hands it a list of data shards.
"""
from __future__ import annotations

import dataclasses
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np
import torch

from ..kernels.reveal import reveal_batch
from ..ops.stats import auc_np, entropy_bits, spearman_np
from ..utils.trace import count, span


@dataclasses.dataclass
class CurveOutputs:
    """Raw per-step curve data for one (start, finish, order) pass."""

    target_prob: np.ndarray      # [n_steps+1] softmax prob of target class
    top1_is_target: np.ndarray   # [n_steps+1] 0/1
    entropy: np.ndarray          # [n_steps+1] bits
    original_pred: float         # target prob of the untouched input
    baseline_pred: float         # target prob of the fully-substituted input
    baseline_top1: float         # top-1-is-target of the substituted input


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


def patch_flip_steps(saliency: np.ndarray, patch_mask: np.ndarray,
                     descending: bool = True) -> np.ndarray:
    """Patch-ranked variant (MASTestFunctions.py:213-223): patches ordered by
    mean saliency; one patch flips per step, so the step count is the
    number of patches."""
    flat = np.asarray(saliency).reshape(-1)
    pm = np.asarray(patch_mask).reshape(-1)
    n_seg = len(np.unique(pm))
    seg_sal = np.zeros(n_seg)
    for i in range(n_seg):
        seg_sal[i] = flat[pm == i].mean()
    if descending:
        order = np.flip(np.argsort(seg_sal, axis=0), axis=-1)
    else:
        order = np.argsort(seg_sal, axis=0)
    seg_step = np.empty(n_seg, dtype=np.int32)
    seg_step[order] = np.arange(n_seg, dtype=np.int32) + 1
    return seg_step[pm]


# ---------------------------------------------------------------------------
# the device engine
# ---------------------------------------------------------------------------

def batched_curves(apply_fn, starts, finishes, flips, targets,
                   n_steps: int, chunk: int):
    """starts/finishes: ``[B, C, H, W]``; flips: ``[B, H, W]`` int32;
    targets: int64 ``[B]``, all on one device.  Returns (target prob,
    top-1 indicator, entropy), each ``[B, n_steps + 1]``, every image read
    at its own target.  Each chunk is one reveal launch of ``B * chunk``
    images into one forward.  When ``chunk`` does not divide the step
    count the last chunk is ragged: it runs only the steps that exist
    (xai_tpu pads to a whole chunk).  The battery (:func:`_battery`) calls
    this once with its three passes stacked as ``3 * B`` images."""
    b = starts.shape[0]
    total = n_steps + 1
    tgt = targets.view(b, 1)
    tp, top1, ent = [], [], []
    for s0 in range(0, total, chunk):
        steps = torch.arange(s0, min(s0 + chunk, total), dtype=torch.int32,
                             device=starts.device)
        imgs = reveal_batch(starts, finishes, flips, steps)
        logits = apply_fn(imgs.flatten(0, 1)).view(b, steps.shape[0], -1)
        p = torch.softmax(logits, dim=-1)
        tp.append(p.gather(2, tgt[:, :, None].expand(-1, p.shape[1], 1))
                  [..., 0])
        top1.append((logits.argmax(dim=-1) == tgt).to(p.dtype))
        ent.append(entropy_bits(p))
    return torch.cat(tp, 1), torch.cat(top1, 1), torch.cat(ent, 1)


# The battery's forwards hold up to this many rows: as many of its three
# passes as fit.  On an H100 under cuDNN's default heuristics (float32,
# two probes of five warm forwards a size, within 0.4 % of each other)
# an R101 forward cost 0.676 ms a row at 45 rows, 0.514 at 135, 0.415 at
# 180, 0.403 at 225, 0.45-0.46 at 270-360, 0.364 and 0.369 at 405 and
# 450, and 0.437 at 540; four images' battery ran 5 % slower in 540-row
# forwards than in 180-row ones.  So one image's three passes share a
# forward and four images keep a pass a forward; three images stay at
# 135-row forwards, though 405 rows read 29 % cheaper a row (not measured
# end to end).  ViT-B/16 and Swin-B gain at most 6 % a row from 180 to
# 540.
FUSED_ROWS = 180


def passes_per_forward(b: int, chunk: int) -> int:
    """How many of the battery's three reveal passes share a forward at
    ``b`` images and ``chunk`` steps (:data:`FUSED_ROWS`), at least
    one."""
    return min(3, max(1, FUSED_ROWS // (b * chunk)))


@torch.inference_mode()
def _battery(apply_fn, blur_fn, x, desc, asc, n_steps: int, chunk: int,
             targets=None):
    """The battery's device work for a batch: one blur launch over all
    ``B*C`` planes, the targets (argmax when None), and the three reveal
    passes (insertion from the blurred image, deletion and LeRF to zeros)
    as one :func:`batched_curves` call over ``3*B`` pseudo-images, so
    each chunk is one reveal launch of ``3*B*chunk`` images.  They go to
    the model in forwards of :func:`passes_per_forward` passes' rows
    (each counted in ``battery_forwards``): one forward of ``3*B*chunk``
    rows while that fits in :data:`FUSED_ROWS` (image by image at 224 px:
    135 rows), and the battery's activation memory grows with a forward's
    rows.  x: [B, C, H, W]; desc/asc: [B, H, W] int32 flip steps;
    targets: int64 [B] or None.  Returns each pass's (target prob, top-1,
    entropy), each [B, n_steps + 1], and the targets."""
    if targets is None:
        targets = apply_fn(x).argmax(dim=-1)
    blurred = blur_fn(x)
    zeros = torch.zeros_like(x)
    group = passes_per_forward(x.shape[0], chunk)

    def forward(imgs):
        # a chunk's images, pass after pass: split at pass boundaries
        logits = []
        for part in imgs.split(group * (imgs.shape[0] // 3)):
            count("battery_forwards")
            logits.append(apply_fn(part))
        return torch.cat(logits)

    passes = batched_curves(forward, torch.cat([blurred, x, x]),
                            torch.cat([x, zeros, zeros]),
                            torch.cat([desc, desc, asc]), targets.repeat(3),
                            n_steps, chunk)
    ins, dele, lerf = zip(*(c.chunk(3) for c in passes))
    return ins, dele, lerf, targets


@torch.no_grad()
def reveal_curves(apply_fn, start, finish, flip_step, n_steps: int,
                  target: int, chunk: int = 25, original_img=None,
                  original_at: Optional[str] = None) -> CurveOutputs:
    """One full reveal pass of one image: the batch of one of
    :func:`batched_curves`, so every chunk is one reveal launch.

    start/finish: ``[H, W, C]`` tensors on the model's device (start is the
    step-0 image, finish the fully-substituted end state); flip_step:
    ``[H*W]`` int flip steps.  ``original_at`` names the endpoint that is
    the clean input ("start" for a deletion pass, "finish" for insertion):
    its prediction is read off the curve, since step 0 is exactly
    ``start`` and step ``n_steps`` exactly ``finish``.  ``original_img``
    serves a caller whose original is neither endpoint (one extra
    forward), or, with ``original_at`` omitted, infers the endpoint by
    exact equality."""
    h, w, _ = start.shape
    dev = start.device
    flips = torch.as_tensor(np.asarray(flip_step, np.int32).reshape(1, h, w),
                            device=dev)
    tgt = torch.tensor([int(target)], dtype=torch.int64, device=dev)
    tp, top1, ent = batched_curves(
        apply_fn, start.permute(2, 0, 1)[None].contiguous(),
        finish.permute(2, 0, 1)[None].contiguous(), flips, tgt, n_steps,
        chunk)
    tp, top1, ent = (v[0].float().cpu().numpy() for v in (tp, top1, ent))
    if original_at is None and original_img is not None:
        # infer the endpoint by EXACT equality (allclose could misclassify
        # an insertion pass on an image ~equal to its substrate)
        if torch.equal(original_img, start):
            original_at = "start"
        elif torch.equal(original_img, finish):
            original_at = "finish"
    if original_at == "start":
        original_pred = float(tp[0])
        baseline_pred = float(tp[-1])
        baseline_top1 = float(top1[-1])
    elif original_at == "finish":
        original_pred = float(tp[-1])
        baseline_pred = float(tp[0])
        baseline_top1 = float(top1[0])
    elif original_img is not None:     # the original is neither endpoint
        logits = apply_fn(original_img.permute(2, 0, 1)[None].contiguous())
        original_pred = float(torch.softmax(logits[0], -1)[int(target)])
        baseline_pred = float(tp[0])
        baseline_top1 = float(top1[0])
    else:
        raise ValueError("pass original_at='start'/'finish' or original_img")
    return CurveOutputs(tp, top1, ent, original_pred, baseline_pred,
                        baseline_top1)


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

def flip_schedules(saliencies: np.ndarray, step_size: int) -> tuple:
    """``[B, H, W]`` saliencies -> (descending, ascending) flip steps,
    each ``[B, H*W]`` int32 (:func:`pixel_flip_steps`, on the host)."""
    with span("battery.schedule"):
        return tuple(np.stack([pixel_flip_steps(s, step_size, descending=d)
                               for s in saliencies]) for d in (True, False))


def battery_curves(apply_fn, blur_fn, x: torch.Tensor, desc: torch.Tensor,
                   asc: torch.Tensor, n_steps: int, chunk: int,
                   targets=None) -> torch.Tensor:
    """The five curves the scores read, ``[5, B, n_steps + 1]`` on ``x``'s
    device (insertion target prob and top-1, deletion target prob and
    top-1, LeRF target prob), enqueued and not read.  x: ``[B, C, H,
    W]``; desc / asc: ``[B, H, W]`` int32 on its device; targets: int64
    ``[B]`` there, or None for argmax."""
    ins, dele, lerf, _ = _battery(apply_fn, blur_fn, x, desc, asc, n_steps,
                                  chunk, targets)
    return torch.stack([ins[0], ins[1], dele[0], dele[1], lerf[0]])


def assemble_scores(curves: np.ndarray, saliencies: np.ndarray,
                    desc: np.ndarray, n_steps: int) -> list:
    """One 10-score dict per image from :func:`battery_curves`' host
    copy ``[5, B, n_steps + 1]``."""
    with span("battery.score"):
        return [assemble_battery_scores(*curves[:, i], saliencies[i],
                                        desc[i], n_steps)
                for i in range(curves.shape[1])]


def battery_scores(apply_fn, images: torch.Tensor, saliencies, blur_fn,
                   step_size: Optional[int] = None, chunk: int = 45,
                   targets=None) -> list:
    """All 10 perturbation scores of each image of a batch.

    apply_fn: NCHW batch -> logits (``bundle.apply``).  images:
    ``[B, H, W, C]`` normalized inputs on the model's device; saliencies:
    ``[B, H, W]``; targets: one class per image, default argmax
    (evaluatePerturbation.py:561).  ``chunk``: the reveal steps one
    launch writes for each pass and image (a forward's rows:
    :func:`_battery`).  Returns one dict per image of the reference's
    Counter keys (evaluatePerturbation.py:484-495) -> float score.
    """
    return _battery_over_shards(
        images, saliencies, blur_fn, chunk, targets,
        [(apply_fn, images.device, slice(None))], step_size)


def run_battery(apply_fn, input_img: torch.Tensor, saliency: np.ndarray,
                blur_fn, step_size: Optional[int] = None, chunk: int = 45,
                target: Optional[int] = None) -> dict:
    """All 10 perturbation scores of one ``[H, W, C]`` image: the batch of
    one of :func:`battery_scores`."""
    return battery_scores(apply_fn, input_img[None],
                          np.asarray(saliency)[None], blur_fn, step_size,
                          chunk, None if target is None else [target])[0]


def _battery_over_shards(images: torch.Tensor, saliencies, blur_fn,
                         chunk: int, targets, shards: list,
                         step_size: Optional[int] = None) -> list:
    """The battery's host flow, under the span ``battery``: every image's
    flip steps on the host, each data shard's :func:`battery_curves`
    enqueued on its device, one device-to-host read of the curves, in
    image order, and the scores.  images: ``[B, H, W, C]``; shards:
    ``[(forward, device, slice of the batch)]``, covering the batch in
    order; ``step_size`` defaults to the image height."""
    saliencies = np.asarray(saliencies)
    b, h, w, _ = images.shape
    step_size = step_size or h
    n_steps = (h * w + step_size - 1) // step_size
    with span("battery") as battery:
        desc, asc = flip_schedules(saliencies, step_size)
        x = images.permute(0, 3, 1, 2).contiguous()
        desc_t = torch.from_numpy(desc.reshape(b, h, w))
        asc_t = torch.from_numpy(asc.reshape(b, h, w))
        if targets is not None:
            targets = torch.as_tensor(targets, dtype=torch.int64)
        # a copy between cards runs on the source card's stream, behind the
        # work queued there, so a copy made after shard 0's battery would
        # hold the next shard until shard 0 had finished
        work = [(battery, str(dev), forward, blur_fn, x[sl].to(dev),
                 desc_t[sl].to(dev), asc_t[sl].to(dev), n_steps, chunk,
                 None if targets is None else targets[sl].to(dev))
                for forward, dev, sl in shards]
        if len(work) == 1:
            out = [_shard_curves(*work[0])]
        else:
            # one host thread a shard: a card's launch queue holds about a
            # thousand kernels and a shard's battery enqueues thousands, so
            # a single thread would wait on shard 0's queue until shard 0
            # had nearly finished before it enqueued shard 1 (the cards
            # would take turns)
            with ThreadPoolExecutor(len(work)) as pool:
                futures = [pool.submit(_shard_curves, *a) for a in work]
                out = [f.result() for f in futures]
        with span("battery.read"):
            host = np.concatenate([c.cpu().numpy() for c in out], axis=1)
        return assemble_scores(host, saliencies, desc, n_steps)


def _shard_curves(battery, card, *args):
    """One data shard's :func:`battery_curves`, enqueued (not read) under
    the span ``battery.shard``, a child of the span ``battery``."""
    with span("battery.shard", parent=battery, card=card):
        return battery_curves(*args)
