"""ConvNeXt (tiny/small/base/large) with taps, as ``nn.Module``s.

Counterpart of ``xai_tpu/models/convnext.py``.  The blocks compute in
``[B, H, W, C]``, as flax does, and convolve through the NCHW view of that
channels-last tensor (``common.conv_nhwc``): a 7x7 depthwise conv,
LayerNorm (eps 1e-6, flax's), a 4x pointwise MLP with exact GELU, the
layer scale ``gamma``, the skip.  The stem (4x4 stride 4) and the
downsampling convs (2x2 stride 2) pad as XLA's ``"SAME"`` does.
Submodule names follow the JAX parameter tree (``stem_conv``,
``stage{s}_block{b}.dwconv``, ``down{s}_norm``, ``head``, ...).
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from .common import (Conv2dSame, LayerNorm, ModelBundle, ModelMeta,
                     conv_nhwc, init_flax_default)


class CNBlock(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.dwconv = nn.Conv2d(dim, dim, 7, padding=3, groups=dim)
        self.norm = LayerNorm(dim, eps=1e-6)
        self.pw1 = nn.Linear(dim, 4 * dim)
        self.pw2 = nn.Linear(4 * dim, dim)
        self.gamma = nn.Parameter(torch.full((dim,), 1e-6))

    def forward(self, x):
        h = self.norm(conv_nhwc(self.dwconv, x))
        h = self.pw2(F.gelu(self.pw1(h)))
        return x + self.gamma * h


class ConvNeXt(nn.Module):
    """``forward(x)`` takes NCHW and returns logits; ``taps=True`` also
    returns {"stage0".."stage3", "layer4": each stage's output}, NCHW."""

    def __init__(self, depths: Sequence[int], dims: Sequence[int],
                 num_classes: int = 1000):
        super().__init__()
        self.depths = tuple(depths)
        self.stem_conv = Conv2dSame(3, dims[0], 4, stride=4)
        self.stem_norm = LayerNorm(dims[0], eps=1e-6)
        for s, (depth, dim) in enumerate(zip(depths, dims)):
            if s > 0:
                setattr(self, f"down{s}_norm", LayerNorm(dims[s - 1],
                                                         eps=1e-6))
                setattr(self, f"down{s}_conv",
                        Conv2dSame(dims[s - 1], dim, 2, stride=2))
            for b in range(depth):
                setattr(self, f"stage{s}_block{b}", CNBlock(dim))
        self.head_norm = LayerNorm(dims[-1], eps=1e-6)
        self.head = nn.Linear(dims[-1], num_classes)

    def forward(self, x, taps: bool = False):
        tap = {}
        y = self.stem_norm(conv_nhwc(self.stem_conv,
                                     x.permute(0, 2, 3, 1)))
        for s, depth in enumerate(self.depths):
            if s > 0:
                y = conv_nhwc(getattr(self, f"down{s}_conv"),
                              getattr(self, f"down{s}_norm")(y))
            for b in range(depth):
                y = getattr(self, f"stage{s}_block{b}")(y)
            tap[f"stage{s}"] = y.permute(0, 3, 1, 2)
        tap["layer4"] = tap[f"stage{len(self.depths) - 1}"]
        logits = self.head(self.head_norm(y.mean(dim=(1, 2))))
        return (logits, tap) if taps else logits


ARCHS = {
    "convnext_tiny": dict(depths=(3, 3, 9, 3), dims=(96, 192, 384, 768)),
    "convnext_small": dict(depths=(3, 3, 27, 3), dims=(96, 192, 384, 768)),
    "convnext_base": dict(depths=(3, 3, 27, 3), dims=(128, 256, 512, 1024)),
    # xai_tpu notes that the reference's CONVNXT is torchvision's
    # convnext_large; its zoo maps CONVNXT to convnext_base all the same
    "convnext_large": dict(depths=(3, 3, 27, 3), dims=(192, 384, 768, 1536)),
}


def make_bundle(arch: str = "convnext_tiny", state: Optional[dict] = None,
                seed: int = 0, batch_size: int = 50,
                device=None) -> ModelBundle:
    """The bundle of a ConvNeXt arch: seeded random weights in flax's
    scheme (layer scale 1e-6), or ``state``, on ``device``."""
    model = init_flax_default(ConvNeXt(num_classes=1000, **ARCHS[arch]),
                              seed)
    if state is not None:
        model.load_state_dict(state)
    meta = ModelMeta(name=arch, family="cnn", batch_size=batch_size)
    return ModelBundle(meta, model.to(device))
