"""Reference-shaped metric classes over the reveal-curve engine.

Counterpart of ``xai_tpu/metrics/classic.py``.  API parity with
util/test_methods/: ``MASMetric(model, HW, mode, step_size,
substrate_fn).single_run(img, saliency, ...)`` and friends; "model" is a
``ModelBundle``, images are ``[H, W, C]`` tensors on its device and the
substrate function maps NCHW to NCHW (``ops/blur.py make_blur_fn``).
Return tuples match the reference's (MASTestFunctions.py:385,
RISETestFunctions.py:237, AICTestFunctions.py:200-225,
PosNegPertFunctions.py:177, MonotonicityTest.py:213).  Every call is one
``reveal_curves`` pass, so its forwards are fed by the reveal kernel.
"""
from __future__ import annotations

import numpy as np
import torch

from ..kernels.reveal import reveal_batch
from ..native import project_curve
from ..ops.stats import spearman_np
from .curves import (density_response, mas_scores, monotone_normalize,
                     patch_flip_steps, pixel_flip_steps, reveal_curves)


class _RevealMetric:
    def __init__(self, bundle, HW: int, mode: str, step_size: int,
                 substrate_fn):
        self.bundle = bundle
        self.HW = HW
        self.mode = mode
        self.step_size = step_size
        self.substrate_fn = substrate_fn

    def _image_and_substrate(self, img):
        img = torch.as_tensor(img, dtype=torch.float32,
                              device=self.bundle.device)
        if img.dim() == 4:
            img = img[0]
        with torch.no_grad():
            sub = self.substrate_fn(img.permute(2, 0, 1)[None].contiguous())
        return img, sub[0].permute(1, 2, 0)

    def _schedule(self, saliency_map, patch_mask, descending):
        if patch_mask is None:
            n_steps = (self.HW + self.step_size - 1) // self.step_size
            flip = pixel_flip_steps(saliency_map, self.step_size, descending)
        else:
            n_steps = len(np.unique(np.asarray(patch_mask)))
            flip = patch_flip_steps(saliency_map, patch_mask, descending)
        return flip, n_steps

    @torch.no_grad()
    def _target(self, img) -> int:
        return int(self.bundle.apply(img.permute(2, 0, 1)[None]
                                     .contiguous())[0].argmax())

    def _run(self, img, saliency_map, patch_mask=None, max_batch_size=50,
             descending=True):
        img, sub = self._image_and_substrate(img)
        flip, n_steps = self._schedule(saliency_map, patch_mask, descending)
        deletion = self.mode in ("del", "morf", "lerf", "negative")
        start, finish = (img, sub) if deletion else (sub, img)
        out = reveal_curves(self.bundle.apply, start, finish, flip, n_steps,
                            self._target(img), chunk=min(max_batch_size, 25),
                            original_at="start" if deletion else "finish")
        return out, flip, n_steps


class MASMetric(_RevealMetric):
    def single_run(self, img_tensor, saliency_map, device=None,
                   patch_mask=None, max_batch_size=50,
                   special_version=False, **_):
        mode = "del" if self.mode in ("del", "morf", "lerf") else "ins"
        descending = self.mode != "lerf"
        out, flip, n_steps = self._run(img_tensor, saliency_map, patch_mask,
                                       max_batch_size, descending)
        norm = monotone_normalize(out.target_prob, out.original_pred,
                                  out.baseline_pred, mode)
        if special_version:
            norm = project_curve(norm, mode)
        dens = density_response(saliency_map, flip, n_steps, mode)
        corrected = mas_scores(norm, dens, mode)
        return n_steps + 1, corrected, out.entropy, dens, norm

    def single_run_embeddings(self, img_tensor, saliency_map,
                              patch_mask=None, max_batch_size=8):
        """return_embeddings=True path (MASTestFunctions.py:370-381):
        (embeddings ``[L, steps+1, N, D]``, classes, model response, the
        flip schedule standing for the salient order)."""
        img, sub = self._image_and_substrate(img_tensor)
        flip, n_steps = self._schedule(saliency_map, patch_mask, True)
        deletion = self.mode in ("del", "morf", "lerf")
        start, finish = (img, sub) if deletion else (sub, img)
        embs, classes = _embeddings_sweep(self.bundle, start, finish, flip,
                                          n_steps, chunk=max_batch_size)
        out = reveal_curves(self.bundle.apply, start, finish, flip, n_steps,
                            self._target(img),
                            chunk=min(max_batch_size, 25),
                            original_at="start" if deletion else "finish")
        return embs, classes, out.target_prob, flip


@torch.no_grad()
def _embeddings_sweep(bundle, start, finish, flip, n_steps, chunk=8):
    """ViT-embedding capture (MASTestFunctions.py:121-132, 283-295): at
    every reveal step, every block's token embeddings (the ``block_out``
    taps) and the predicted class; each chunk is one reveal launch into
    one forward with taps.  Returns (``[L, steps+1, N, D]`` numpy,
    ``[steps+1]`` classes)."""
    h, w, _ = start.shape
    dev = start.device
    flips = torch.as_tensor(np.asarray(flip, np.int32).reshape(1, h, w),
                            device=dev)
    s0 = start.permute(2, 0, 1)[None].contiguous()
    f0 = finish.permute(2, 0, 1)[None].contiguous()
    embs, classes = [], []
    for lo in range(0, n_steps + 1, chunk):
        steps = torch.arange(lo, min(lo + chunk, n_steps + 1),
                             dtype=torch.int32, device=dev)
        imgs = reveal_batch(s0, f0, flips, steps)[0]
        logits, taps = bundle.apply_taps(imgs)
        embs.append(taps["block_out"].float().cpu().numpy())
        classes.append(logits.argmax(-1).cpu().numpy())
    return np.concatenate(embs, axis=1), np.concatenate(classes)


class RISEMetric(_RevealMetric):
    def single_run(self, img_tensor, saliency_map, device=None,
                   patch_mask=None, max_batch_size=50, **_):
        mode = "del" if self.mode in ("del", "morf", "lerf") else "ins"
        descending = self.mode != "lerf"
        out, _, n_steps = self._run(img_tensor, saliency_map, patch_mask,
                                    max_batch_size, descending)
        norm = monotone_normalize(out.target_prob, out.original_pred,
                                  out.baseline_pred, mode)
        return n_steps + 1, out.entropy, norm


class AICMetric(_RevealMetric):
    def single_run(self, img_tensor, saliency_map, device=None,
                   patch_mask=None, max_batch_size=50, decision_flip=False,
                   **_):
        out, _, n_steps = self._run(img_tensor, saliency_map, patch_mask,
                                    max_batch_size, True)
        resp = out.top1_is_target
        if decision_flip:
            if self.mode == "del":
                hits = np.where(resp == 0)[0]
            else:
                hits = np.where(resp == 1)[0]
            score = hits[0] / len(resp) if len(hits) else 1.0
            return score, resp
        norm = monotone_normalize(resp, 1.0, out.baseline_top1, self.mode)
        return n_steps + 1, norm


class PositiveNegativePerturbation(_RevealMetric):
    """MoRF/LeRF: always deletion-direction; returns the RAW response
    (PosNegPertFunctions.py:177)."""

    def single_run(self, img_tensor, saliency_map, device=None,
                   patch_mask=None, max_batch_size=50, **_):
        descending = self.mode == "morf"
        out, _, n_steps = self._run(img_tensor, saliency_map, patch_mask,
                                    max_batch_size, descending)
        return n_steps + 1, out.target_prob


class MonotonicityMetric(_RevealMetric):
    def single_run(self, img_tensor, saliency_map, device=None,
                   patch_mask=None, max_batch_size=50, **_):
        # positive = insertion start, negative = deletion; order always desc
        out, _, n_steps = self._run(img_tensor, saliency_map, patch_mask,
                                    max_batch_size, True)
        ideal = (np.linspace(0, 1, n_steps + 1) if self.mode == "positive"
                 else np.linspace(1, 0, n_steps + 1))
        mono = spearman_np(ideal, out.target_prob)
        return out.target_prob, mono
