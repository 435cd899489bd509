"""CLIP Surgery: training-free dense similarity maps.

Counterpart of ``xai_tpu/methods/clip_surgery.py`` (reference:
util/attribution_methods/CLIP/CLIP_Surgery/).  The "architecture surgery"
(clip_surgery_model.py:58-106, 317-355) re-wires the standard weights:

- the last 6 visual blocks run two paths: the original path unchanged,
  and the surgery path, which adds v-v self-attention (q = k = v) and
  skips the FFN;
- the surgery path's CLS row is the original path's, before ``ln_post``
  and the projection;
- feature surgery (clip.py:287-309): per-token products with the
  class-probability weights, minus the mean over the classes;
- the similarity map (clip.py:271-284): min-max per class over the
  tokens, on the grid, upsampled bilinearly (``ops/resize.py``, xai_tpu's
  ``jax.image.resize`` weights).

Every function takes a batch and keeps each reduction per image; the
explainers' two-pass LayerNorm (``clip_explain.ln``) throughout, logits
``einsum * scale`` for both q-k and v-v.
"""
from __future__ import annotations

import torch

from ..ops.resize import resize_bilinear
from ..utils import trace
from .clip_explain import _prepare, _unit, dense, ln, mlp, mm

SURGERY_DEPTH = 6
# target caption plus 59 other classes (evaluatePerturbation.py:425-429)
SURGERY_CLASSES = 60


def mha(x, attn, heads: int, surgery: bool = True):
    """(surgery path output or None, original path output) of one
    attention module on its normalized input ``x`` ``[B, N, C]``."""
    b, n, c = x.shape
    hd = c // heads
    qkv = dense(x, attn.in_proj).view(b, n, 3, heads, hd)
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    scale = hd ** -0.5

    def proj(t):
        return dense(t.transpose(1, 2).reshape(b, n, c), attn.out_proj)

    x_ori = mm(torch.softmax(mm(q, k.transpose(-2, -1)) * scale, dim=-1), v)
    if not surgery:
        return None, proj(x_ori)
    x_new = mm(torch.softmax(mm(v, v.transpose(-2, -1)) * scale, dim=-1), v)
    return proj(x_new), proj(x_ori)


@torch.no_grad()
def surgery_encode(bundle, x) -> torch.Tensor:
    """Every token's projected feature ``[B, N, E]`` from the dual-path
    visual tower."""
    visual = bundle.module.visual
    xb = _prepare(bundle, x)
    trace.count("model_rows", xb.shape[0])
    y = visual.conv1(xb).flatten(2).transpose(1, 2)
    y = torch.cat([visual.class_embedding.expand(y.shape[0], 1, -1), y],
                  dim=1)
    y = ln(y + visual.positional_embedding, visual.ln_pre)
    blocks = visual.blocks()
    start = len(blocks) - SURGERY_DEPTH
    x_cur, x_new = y, None
    for i, blk in enumerate(blocks):
        a_new, a_ori = mha(ln(x_cur, blk.ln_1), blk.attn,
                           visual.cfg.vision_heads, surgery=i >= start)
        if a_new is not None:
            # the first surgery block starts the path; later ones add to
            # it and skip the FFN
            x_new = (x_cur if x_new is None else x_new) + a_new
        x_cur = x_cur + a_ori
        x_cur = x_cur + mlp(ln(x_cur, blk.ln_2), blk)
    # the surgery path's CLS is the original path's (:351)
    x_new = torch.cat([x_cur[:, :1], x_new[:, 1:]], dim=1)
    return mm(ln(x_new, visual.ln_post), visual.proj)


def clip_feature_surgery(image_features, text_features, t: float = 2.0):
    """clip.py:287-309, redundant-feature removal.  image_features ``[B, N,
    E]``, text_features ``[B, T, E]`` -> ``[B, N, T]``."""
    prob = torch.softmax(mm(image_features[:, :1],
                            text_features.transpose(-2, -1)) * t, dim=-1)
    w = prob / prob.mean(-1, keepdim=True)
    feats = image_features[:, :, None, :] * text_features[:, None]
    feats = feats * w[..., None]
    redundant = feats.mean(2, keepdim=True)
    return (feats - redundant).sum(-1)


def get_similarity_map(sm, hw: int):
    """clip.py:271-284: ``[B, N, T]`` -> min-max per class over the
    tokens, the grid, bilinear to ``[B, hw, hw, T]``."""
    lo = sm.amin(1, keepdim=True)
    hi = sm.amax(1, keepdim=True)
    sm = (sm - lo) / (hi - lo)
    b, n, t = sm.shape
    side = int(round(n ** 0.5))
    grid = sm.permute(0, 2, 1).reshape(b, t, side, side)
    return resize_bilinear(grid, (hw, hw)).permute(0, 2, 3, 1)


def surgery_text_table(bundle, targets) -> torch.Tensor:
    """Each image's text table ``[B, T, E]``: its target's caption, then
    the other classes of the first ``SURGERY_CLASSES`` in index order (the
    redundant-feature removal needs more than one class; with one the
    mean-subtraction zeroes the map)."""
    table = bundle.extras["text_embeddings"]
    n = min(SURGERY_CLASSES, table.shape[0])
    tg = torch.as_tensor(targets, dtype=torch.int64,
                         device=table.device).view(-1, 1)
    j = torch.arange(n - 1, device=table.device)[None]
    others = torch.where(j < tg, j, j + 1)
    return table[torch.cat([tg, others], dim=1)]


def surgery_map(bundle, x, text_features) -> torch.Tensor:
    """clip_surgery_map (generate_emap.py:117-132): ``[B, H, W]``, the
    first caption's channel of each image's similarity map (the driver's
    ``[0, :, :, 0]``).  text_features: ``[B, T, E]``."""
    feats = _unit(surgery_encode(bundle, x))
    sim = clip_feature_surgery(feats, text_features)
    # min-max and resize act per channel: channel 0 alone is the same
    return get_similarity_map(sim[:, 1:, :1], x.shape[1])[..., 0]
