"""ViT attention explainers: raw attention, attention gradient, cam-attn,
naive and residual rollout, transition attention (t_attn), attention IG,
attn_attr, bidirectional (bi_attn) and InFlow/RAVE.

Counterpart of ``xai_tpu/methods/vit_explain.py`` (reference:
util/attribution_methods/VIT_LRP/ViT_explanation_generator.py, Baselines).
The attention gradients come from ``torch.autograd.grad`` on the model's
additive zero probes (``models/vit.py``); every rollout is a chain of
batched matrix products over the stacked ``[L, B, H, N, N]`` taps.

Every public function takes a batch: normalized ``[B, H, W, C]`` images
on the model's device and one target a row (an int64 ``[B]``, or a
sequence), and returns the ``[B, P, P]`` patch maps (CLS row, no resize:
the registry upsamples).  xai_tpu computes each image as a batch of one,
and batches by vmapping that; here every reduction that xai_tpu takes
over its whole batch-of-one tensor (transition attention's
``einsum("biw,bwh->h")``, cam-attn's min-max, the head weights'
``ih / ih.sum()``, the InFlow norm ratios) is taken per image, so a row
of a batch is the image alone.  The model runs in the bundle's dtype
(bf16 on the cast copy), and so do the maps computed from its taps.
"""
from __future__ import annotations

import torch

from ..models import vit as vitmod
from ..models.common import target_scores
from .gradient import _interp, _uniform_alphas


# ---------------------------------------------------------------------------
# collection: one probed forward and backward
# ---------------------------------------------------------------------------

def _prepare(bundle, x, targets):
    """``[B, H, W, C]`` -> NCHW in the bundle's dtype, and int64 targets."""
    xb = x.permute(0, 3, 1, 2).contiguous().to(bundle.dtype)
    tg = torch.as_tensor(targets, dtype=torch.int64,
                         device=xb.device).view(-1)
    return xb, tg


def _score(logits, tg):
    """The sum over the rows of each row's target logit: the gradient of
    the sum is each row's own (rows share nothing)."""
    return target_scores(logits, tg).sum()


@torch.no_grad()
def _taps(bundle, xb):
    return bundle.apply_taps(xb)[1]


def collect(bundle, x, targets):
    """(taps, attn_grads): the stacked taps of one forward and
    d logit[target] / d attention of every block, ``[L, B, H, N, N]``."""
    xb, tg = _prepare(bundle, x, targets)
    return _collect(bundle, xb, tg)


def _collect(bundle, xb, tg):
    cfg = bundle.extras
    probes = vitmod.zero_probes(cfg, xb.shape[0], xb.dtype, xb.device)
    probe = probes["attn"].requires_grad_(True)
    with torch.enable_grad():
        logits, taps = bundle.apply_probed(xb, {"attn": probe})
        (grads,) = torch.autograd.grad(_score(logits, tg), probe)
    return {k: v.detach() for k, v in taps.items()}, grads


def _attn_ig_grads(bundle, xb, tg, steps: int, chunk: int = 20):
    """Sum over alpha in linspace(0, 1, steps) of d logit[target] /
    d attention of the LAST block at input x * alpha
    (ViT_explanation_generator.py:329-341), ``[B, H, N, N]``: one forward
    and backward a ``chunk`` of the ``B * steps`` rows, with a probe on the
    last block only.  Row 0 of each image is the all-zero input."""
    cfg = bundle.extras
    b = xb.shape[0]
    n = b * steps
    build = _interp(_uniform_alphas(b, steps, xb), xb.float())
    rows_tg = tg.repeat_interleave(steps)
    grads = []
    for lo in range(0, n, chunk):
        hi = min(lo + chunk, n)
        probe = torch.zeros((hi - lo, cfg.num_heads, cfg.tokens, cfg.tokens),
                            dtype=xb.dtype, device=xb.device,
                            requires_grad=True)
        with torch.enable_grad():
            logits = bundle.module(build(lo, hi).to(xb.dtype), probes={
                "attn": [None] * (cfg.depth - 1) + [probe]})
            (g,) = torch.autograd.grad(_score(logits, rows_tg[lo:hi]), probe)
        grads.append(g)
    return torch.cat(grads).view((b, steps) + grads[0].shape[1:]).sum(1)


# ---------------------------------------------------------------------------
# rollout primitives (compute_rollout_* / compute_RAVE)
# ---------------------------------------------------------------------------

def rollout_naive(mats, start_layer: int = 0):
    """``[L, B, N, N]`` -> the product M_{L-1} @ ... @ M_start (:13-22)."""
    joint = mats[start_layer]
    for i in range(start_layer + 1, mats.shape[0]):
        joint = mats[i] @ joint
    return joint


def rollout_residual(mats, start_layer: int = 0):
    """0.5A + 0.5I residual modelling: add I, row-normalize, chain
    (:26-45)."""
    n = mats.shape[-1]
    aug = mats + torch.eye(n, dtype=mats.dtype, device=mats.device)
    aug = aug / aug.sum(dim=-1, keepdim=True)
    return rollout_naive(aug, start_layer)


def rave_matrices(attns, bias1, bias2, ablate: int = 0):
    """compute_RAVE augmentation (:48-82).  attns: ``[L, B, N, N]``;
    bias1 / bias2: ``[L, 2, B, N]`` normalized (input, main) L2-norm ratios
    per residual connection."""
    m1 = attns * bias1[:, 1, :, None, :] + torch.diag_embed(bias1[:, 0])
    if ablate == 1:
        aug = m1
    else:
        ratio = bias2[:, 1] / bias2[:, 0]                       # [L, B, N]
        ratio = ratio / ratio.abs().sum(dim=-1, keepdim=True)
        # m1 @ diag(d) is m1 with column k scaled by d[k], exactly: each
        # sum has one non-zero term
        aug = m1 * (ratio * bias2[:, 1] + bias2[:, 0])[:, :, None, :]
    return aug / aug.sum(dim=-1, keepdim=True)


def _resid_biases(taps):
    """Per-block normalized L2-norm ratios of (input, attn_out) and
    (input + attn, mlp), the InFlow residual biases (:221-233).  Returns
    (bias1, bias2), each ``[L, 2, B, N]``."""
    def norms(a, b):
        s = torch.stack([torch.linalg.vector_norm(a, dim=-1),
                         torch.linalg.vector_norm(b, dim=-1)], dim=1)
        return s / s.abs().sum(dim=1, keepdim=True)

    return (norms(taps["block_in"], taps["attn_out"]),
            norms(taps["input_plus_attn"], taps["mlp_val"]))


def _cls_patch_grid(rows):
    """``[B, N]`` CLS rows -> ``[B, P, P]`` patch grids."""
    p = int((rows.shape[-1] - 1) ** 0.5)
    return rows[:, 1:].reshape(rows.shape[0], p, p)


# ---------------------------------------------------------------------------
# the explainers (ViT_explanation_generator.Baselines)
# ---------------------------------------------------------------------------

def raw_attn(bundle, x, layer: int = -1):
    """generate_raw_attn (:140-145): the block's head-mean CLS row."""
    xb, _ = _prepare(bundle, x, [])
    return _cls_patch_grid(_taps(bundle, xb)["attn"][layer].mean(1)[:, 0])


def attn_grad(bundle, x, targets, layer: int = -1):
    """generate_grad (:147-158): head-mean attention gradient CLS row,
    clamped at 0."""
    _, grads = collect(bundle, x, targets)
    return _cls_patch_grid(grads[layer].mean(1)[:, 0]).clamp(min=0)


def cam_attn(bundle, x, targets, layer: int = -1):
    """generate_cam_attn (:161-178): Grad-CAM on the block's attention,
    min-max normalized per image."""
    taps, grads = collect(bundle, x, targets)
    cam = taps["attn"][layer][:, :, 0, 1:]              # [B, H, P*P]
    g = grads[layer][:, :, 0, 1:]
    m = (cam * g).mean(1).clamp(min=0)
    lo = m.min(dim=-1, keepdim=True).values
    hi = m.max(dim=-1, keepdim=True).values
    m = (m - lo) / (hi - lo)
    p = int(m.shape[-1] ** 0.5)
    return m.reshape(-1, p, p)


def naive_rollout(bundle, x, start_layer: int = 0):
    """generate_naive_rollout (:180-193)."""
    return _rollout(bundle, x, start_layer, residual=False)


def rollout(bundle, x, start_layer: int = 0):
    """generate_rollout (:195-239, InFlow=False)."""
    return _rollout(bundle, x, start_layer, residual=True)


def _rollout(bundle, x, start_layer, residual):
    xb, _ = _prepare(bundle, x, [])
    mats = _taps(bundle, xb)["attn"].mean(2)           # [L, B, N, N]
    ro = (rollout_residual if residual else rollout_naive)(mats, start_layer)
    return _cls_patch_grid(ro[:, 0])


def inflow_rollout(bundle, x):
    """generate_rollout(InFlow=True): RAVE with plain head-mean
    attention."""
    xb, _ = _prepare(bundle, x, [])
    taps = _taps(bundle, xb)
    aug = rave_matrices(taps["attn"].mean(2), *_resid_biases(taps))
    return _cls_patch_grid(rollout_naive(aug)[:, 0])


def _state_rollout(attn_mean, blocks):
    """The CLS row of the last block's head-mean attention, carried back
    through ``blocks`` (last first) as ``states @ A + states``: the
    reference's ``einsum("biw,bwh->h")`` of one image, per image."""
    states = attn_mean[-1][:, :1, :]                   # [B, 1, N]
    for i in reversed(blocks):
        states = states @ attn_mean[i] + states
    return states


def transition_attention(bundle, x, targets, start_layer: int = 0,
                         steps: int = 20):
    """generate_transition_attention_maps (:307-356): the ``final``
    (states * W_state) map the driver uses (evaluatePerturbation.py:223).
    The taps are those of the unprobed forward: a zero probe leaves every
    map as it is."""
    xb, tg = _prepare(bundle, x, targets)
    attn_mean = _taps(bundle, xb)["attn"].mean(2)
    states = _state_rollout(attn_mean, range(start_layer, attn_mean.shape[0]))
    total = _attn_ig_grads(bundle, xb, tg, steps)
    w_state = (total / steps).clamp(min=0).mean(1)[:, :1, :]
    return _cls_patch_grid((states * w_state)[:, 0])


def attn_ig(bundle, x, targets, steps: int = 20):
    """Baselines.IG (:358-386): IG of the last block's attention gradients
    alone."""
    xb, tg = _prepare(bundle, x, targets)
    total = _attn_ig_grads(bundle, xb, tg, steps)
    return _cls_patch_grid((total / steps).clamp(min=0).mean(1)[:, 0])


def attn_attr(bundle, x, targets, start_layer: int = 0):
    """attn_attr (:390-416): the residual-free rollout of blocks < L-1
    weighted by the last block's positive attention gradients."""
    taps, grads = collect(bundle, x, targets)
    attn_mean = taps["attn"].mean(2)
    states = _state_rollout(attn_mean,
                            range(start_layer, attn_mean.shape[0] - 1))
    w = grads[-1].clamp(min=0).mean(1)[:, :1, :]
    return _cls_patch_grid((states * w)[:, 0])


def _head_weights(a, g):
    """Head importance Ih = mean |A^T G| over (N, N), normalized over the
    heads of each image (bidirectional :434-441).  a, g: ``[B, H, N, N]``
    -> ``[B, H]``."""
    ih = (a.transpose(-2, -1) @ g).abs().mean(dim=(-1, -2))
    return ih / ih.sum(dim=-1, keepdim=True)


def _head_weighted_cams(taps, grads, start_layer: int):
    """Per block from ``start_layer - 1`` on: sum_h Ih_h A_h, ``[B, N, N]``
    (None before it)."""
    attn = taps["attn"]
    cams = []
    for nb in range(attn.shape[0]):
        if nb < start_layer - 1:
            cams.append(None)
            continue
        ih = _head_weights(attn[nb], grads[nb])
        cams.append(torch.einsum("bh,bhnm->bnm", ih, attn[nb]))
    return cams


def bidirectional(bundle, x, targets, steps: int = 20, start_layer: int = 4):
    """bidirectional / bi_attn (:419-505): the head-importance rollout
    R = I + sum cam @ R over blocks >= start_layer - 1, times the 20-step
    IG of the last block's attention gradients."""
    xb, tg = _prepare(bundle, x, targets)
    taps, grads = _collect(bundle, xb, tg)
    n = taps["attn"].shape[-1]
    r = torch.eye(n, dtype=xb.dtype, device=xb.device).expand(
        xb.shape[0], n, n)
    for cam in _head_weighted_cams(taps, grads, start_layer):
        if cam is not None:
            r = r + cam @ r
    total = _attn_ig_grads(bundle, xb, tg, steps)
    w = (total / steps).clamp(min=0).mean(1)
    return _cls_patch_grid((w * r)[:, 0])


def rave(bundle, x, targets, withgrad: bool = True, ablate: int = 0,
         stop_layer: int = 12):
    """generate_RAVE / InFlow (:241-304): per block the head-importance
    max attention, optionally weighted by the bottom-up gradient (the
    gradient of the block's own classification probs with respect to its
    attention), then the RAVE residual rollout."""
    xb, tg = _prepare(bundle, x, targets)
    taps, grads = _collect(bundle, xb, tg)
    attn = taps["attn"]
    n_used = min(stop_layer + 1, attn.shape[0])
    bu = _bottom_up_attn_grads(bundle, xb, tg) if withgrad else None
    layer_maps = []
    for i in range(n_used):
        ih = _head_weights(attn[i], grads[i])
        max_heads = (attn[i] * ih[:, :, None, None]).amax(dim=1)  # [B,N,N]
        if withgrad:
            max_heads = (bu[i].mean(1) * max_heads).clamp(min=0)
        layer_maps.append(max_heads)
    b1, b2 = _resid_biases(taps)
    aug = rave_matrices(torch.stack(layer_maps), b1[:n_used], b2[:n_used],
                        ablate)
    return _cls_patch_grid(rollout_naive(aug)[:, 0])


def _bottom_up_attn_grads(bundle, xb, tg):
    """d blockprobs_i[target] / d attn_i for every block i
    (ViT_new_timm.py:483-495 + generate_RAVE :278-281): the gradient of
    the final norm and head applied to block i's output, taken with
    respect to block i's own attention.  One forward; one backward a
    block, each from its own probe.  ``[L, B, H, N, N]``."""
    cfg = bundle.extras
    probes = [torch.zeros((xb.shape[0], cfg.num_heads, cfg.tokens,
                           cfg.tokens), dtype=xb.dtype, device=xb.device,
                          requires_grad=True) for _ in range(cfg.depth)]
    with torch.enable_grad():
        _, taps = bundle.apply_probed(xb, {"attn": probes})
        probs = vitmod.block_probs(bundle.module, taps["block_out"])
        grads = [torch.autograd.grad(_score(probs[i], tg), probes[i],
                                     retain_graph=i < cfg.depth - 1)[0]
                 for i in range(cfg.depth)]
    return torch.stack(grads)
