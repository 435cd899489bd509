"""ConvNeXt (tiny/small/base/large) with taps, as ``nn.Module``s.

Counterpart of ``xai_tpu/models/convnext.py``.  The blocks compute in
``[B, H, W, C]``, as flax does: a 7x7 depthwise conv, LayerNorm (eps
1e-6, flax's), a 4x pointwise MLP with exact GELU, the layer scale
``gamma``, the skip.  The stem (4x4 stride 4) and the downsampling convs
(2x2 stride 2) pad as XLA's ``"SAME"`` does.  Submodule names follow the
JAX parameter tree (``stem_conv``, ``stage{s}_block{b}.dwconv``,
``down{s}_norm``, ``head``, ...).

Every activation from the stem on is dense ``[B, H, W, C]`` memory: the
forward makes the stem's input contiguous, and each convolution
(:func:`_conv_dense`) convolves the NCHW view of that channels-last
tensor, which cuDNN writes back channels-last.  So each linear folds the
pixels into one ``addmm`` and each LayerNorm gets a contiguous input,
which under no-grad takes the fused kernel (``common._fused_layernorm``).

Counters (``utils/trace.py``): ``cnblock_rows``, each ``CNBlock`` call's
batch x H x W, the pixels of its depthwise conv and the token rows of its
LayerNorm and MLP; 17,199 a model row at convnext_base's 224 px (3 x 56²
+ 3 x 28² + 27 x 14² + 3 x 7²); ``cnblock_dense_rows`` the same where the
block's input is dense ``[B, H, W, C]`` memory, which it is on every
call.

Part spans (``utils/trace.py``): six a block (the depthwise ``conv``, its
LayerNorm ``norm``, ``pw1`` ``linear``, GELU ``pointwise``, ``pw2``
``linear``, the layer scale and skip ``pointwise``), three in the stem
(the input's NHWC copy ``layout``, ``conv``, ``norm``), two in each
downsampling (``norm``, ``conv``) and three in the head (the mean-pool
``pointwise``, ``norm``, ``linear``).
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn as nn

from ..utils import trace
from .common import (Conv2dSame, LayerNorm, ModelBundle, ModelMeta,
                     conv_nhwc, init_flax_default, linear, mlp)


def _conv_dense(conv: nn.Module, x):
    """``conv`` of a dense ``[B, H, W, C]`` batch through
    ``common.conv_nhwc``, returned dense.  cuDNN and the CPU convolve the
    channels-last view and write channels-last, so ``contiguous`` copies
    nothing there; the meta device writes NCHW.  One ``conv`` part."""
    with trace.part("conv", x):
        return conv_nhwc(conv, x).contiguous()


class CNBlock(nn.Module):
    """7x7 depthwise conv, LayerNorm, Linear C -> 4C, GELU, Linear 4C ->
    C, the layer scale, the skip; counts its input's batch x pixels into
    ``cnblock_rows``, and into ``cnblock_dense_rows`` where the input is
    dense ``[B, H, W, C]`` memory."""

    def __init__(self, dim: int):
        super().__init__()
        self.dwconv = nn.Conv2d(dim, dim, 7, padding=3, groups=dim)
        self.norm = LayerNorm(dim, eps=1e-6)
        self.pw1 = nn.Linear(dim, 4 * dim)
        self.pw2 = nn.Linear(4 * dim, dim)
        self.gamma = nn.Parameter(torch.full((dim,), 1e-6))

    def forward(self, x):
        rows = math.prod(x.shape[:-1])
        trace.count("cnblock_rows", rows)
        if x.is_contiguous():
            trace.count("cnblock_dense_rows", rows)
        h = mlp(self.pw1, self.pw2, self.norm(_conv_dense(self.dwconv, x)))
        with trace.part("pointwise", h):
            return x + self.gamma * h


class ConvNeXt(nn.Module):
    """``forward(x)`` takes NCHW and returns logits; ``taps=True`` also
    returns {"stage0".."stage3", "layer4": each stage's output}, NCHW
    views of channels-last memory."""

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

    @trace.tiled
    def forward(self, x, taps: bool = False):
        tap = {}
        with trace.part("layout", x):
            y = x.permute(0, 2, 3, 1).contiguous()
        y = self.stem_norm(_conv_dense(self.stem_conv, y))
        for s, depth in enumerate(self.depths):
            if s > 0:
                y = _conv_dense(getattr(self, f"down{s}_conv"),
                                getattr(self, f"down{s}_norm")(y))
            for b in range(depth):
                y = getattr(self, f"stage{s}_block{b}")(y)
            tap[f"stage{s}"] = y.permute(0, 3, 1, 2)
        tap["layer4"] = tap[f"stage{len(self.depths) - 1}"]
        with trace.part("pointwise", y):
            y = y.mean(dim=(1, 2))
        logits = linear(self.head, self.head_norm(y))
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
