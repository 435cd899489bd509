"""PVT v1 (tiny/small/medium) with taps, as ``nn.Module``s.

Counterpart of ``xai_tpu/models/pvt.py``: the Pyramid Vision Transformer
with spatial-reduction attention.  Each stage embeds its input with a
strided patch conv (XLA ``"SAME"`` padding), adds its own positional
embedding ``pos_embed{s}`` and runs its blocks on ``[B, N, C]`` tokens;
the cls token joins only in the last stage, and its final-norm row feeds
the head.  The spatial reduction (an ``sr`` conv of kernel and stride
``sr_ratio``, then LayerNorm) leaves the cls token out: ``extra = N -
H*W`` leading tokens pass through as they are.  LayerNorm eps 1e-6,
exact GELU; the family is "vit", normalized with (0.5, 0.5, 0.5) as
xai_tpu's finder normalizes it.

Submodule names follow the JAX parameter tree (``patch_embed{s}``,
``embed_norm{s}``, ``pos_embed{s}``, ``cls_token``,
``stage{s}_block{b}.attn.sr``, ``norm``, ``head``, ...).
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.preprocess import VIT_MEAN, VIT_STD
from .common import (Conv2dSame, LayerNorm, ModelBundle, ModelMeta,
                     conv_nhwc, init_flax_default)


class SRAttention(nn.Module):
    def __init__(self, dim: int, num_heads: int, sr_ratio: int):
        super().__init__()
        self.num_heads = num_heads
        self.q = nn.Linear(dim, dim)
        if sr_ratio > 1:
            self.sr = Conv2dSame(dim, dim, sr_ratio, stride=sr_ratio)
            self.sr_norm = LayerNorm(dim, eps=1e-6)
        else:
            self.sr = None
        self.kv = nn.Linear(dim, 2 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x, hw):
        """x: ``[B, N, C]`` (cls first, where there is one); hw: the patch
        grid's (H, W)."""
        b, n, c = x.shape
        h = self.num_heads
        q = self.q(x).view(b, n, h, c // h).transpose(1, 2)
        kv_in = x
        if self.sr is not None:
            gh, gw = hw
            extra = n - gh * gw        # cls token(s) excluded from reduction
            red = conv_nhwc(self.sr, x[:, extra:].reshape(b, gh, gw, c))
            red = self.sr_norm(red.reshape(b, -1, c))
            kv_in = torch.cat([x[:, :extra], red], dim=1) if extra else red
        kv = self.kv(kv_in)
        m = kv.shape[1]
        kv = kv.view(b, m, 2, h, c // h)
        k, v = kv[:, :, 0].transpose(1, 2), kv[:, :, 1].transpose(1, 2)
        attn = torch.softmax((q @ k.transpose(-2, -1)) * (c // h) ** -0.5,
                             dim=-1).to(x.dtype)
        out = (attn @ v).transpose(1, 2).reshape(b, n, c)
        return self.proj(out)


class PVTBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_ratio: int,
                 sr_ratio: int):
        super().__init__()
        self.norm1 = LayerNorm(dim, eps=1e-6)
        self.attn = SRAttention(dim, num_heads, sr_ratio)
        self.norm2 = LayerNorm(dim, eps=1e-6)
        self.mlp_fc1 = nn.Linear(dim, dim * mlp_ratio)
        self.mlp_fc2 = nn.Linear(dim * mlp_ratio, dim)

    def forward(self, x, hw):
        x = x + self.attn(self.norm1(x), hw)
        return x + self.mlp_fc2(F.gelu(self.mlp_fc1(self.norm2(x))))


class PVT(nn.Module):
    """``forward(x)`` takes NCHW at ``img_hw`` and returns logits;
    ``taps=True`` also returns {"stage0".."stage2": each earlier stage's
    output NCHW, "layer4": the last stage's tokens ``[B, 1 + H*W, C]``,
    before the final norm}."""

    def __init__(self, depths: Sequence[int] = (2, 2, 2, 2),
                 dims: Sequence[int] = (64, 128, 320, 512),
                 num_heads: Sequence[int] = (1, 2, 5, 8),
                 mlp_ratios: Sequence[int] = (8, 8, 4, 4),
                 sr_ratios: Sequence[int] = (8, 4, 2, 1),
                 patch_sizes: Sequence[int] = (4, 2, 2, 2),
                 num_classes: int = 1000, img_hw: int = 224):
        super().__init__()
        self.depths = tuple(depths)
        self.dims = tuple(dims)
        self.grids = []
        grid, cin, last = img_hw, 3, len(depths) - 1
        for s in range(len(depths)):
            ps = patch_sizes[s]
            grid //= ps
            self.grids.append(grid)
            setattr(self, f"patch_embed{s}",
                    Conv2dSame(cin, dims[s], ps, stride=ps))
            setattr(self, f"embed_norm{s}", LayerNorm(dims[s], eps=1e-6))
            n_tokens = grid * grid + (s == last)
            setattr(self, f"pos_embed{s}",
                    nn.Parameter(torch.zeros(1, n_tokens, dims[s])))
            for b in range(depths[s]):
                setattr(self, f"stage{s}_block{b}", PVTBlock(
                    dims[s], num_heads[s], mlp_ratios[s], sr_ratios[s]))
            cin = dims[s]
        self.cls_token = nn.Parameter(torch.zeros(1, 1, dims[last]))
        self.norm = LayerNorm(dims[last], eps=1e-6)
        self.head = nn.Linear(dims[last], num_classes)

    def forward(self, x, taps: bool = False):
        tap = {}
        bsz = x.shape[0]
        y = x.permute(0, 2, 3, 1)
        last = len(self.depths) - 1
        for s, grid in enumerate(self.grids):
            y = conv_nhwc(getattr(self, f"patch_embed{s}"), y)
            y = y.reshape(bsz, grid * grid, self.dims[s])
            y = getattr(self, f"embed_norm{s}")(y)
            if s == last:
                y = torch.cat([self.cls_token.expand(bsz, -1, -1), y], 1)
            y = y + getattr(self, f"pos_embed{s}")
            for b in range(self.depths[s]):
                y = getattr(self, f"stage{s}_block{b}")(y, (grid, grid))
            if s != last:
                y = y.reshape(bsz, grid, grid, self.dims[s])
                tap[f"stage{s}"] = y.permute(0, 3, 1, 2)
        tap["layer4"] = y
        logits = self.head(self.norm(y)[:, 0])
        return (logits, tap) if taps else logits


ARCHS = {
    "pvt_tiny": dict(depths=(2, 2, 2, 2)),
    "pvt_small": dict(depths=(3, 4, 6, 3)),
    "pvt_medium": dict(depths=(3, 4, 18, 3)),
}


def make_bundle(arch: str = "pvt_tiny", state: Optional[dict] = None,
                seed: int = 0, batch_size: int = 25,
                device=None) -> ModelBundle:
    """The bundle of a PVT arch at 224 px: seeded random weights in flax's
    scheme, or ``state``, on ``device``."""
    model = init_flax_default(PVT(num_classes=1000, **ARCHS[arch]), seed)
    if state is not None:
        model.load_state_dict(state)
    meta = ModelMeta(name=arch, family="vit", batch_size=batch_size,
                     mean=VIT_MEAN, std=VIT_STD)
    return ModelBundle(meta, model.to(device))
