"""MaxViT (tiny) with taps, as ``nn.Module``s, in both of xai_tpu's forms.

Counterpart of ``xai_tpu/models/maxvit.py``.  Every block is an MBConv,
then block (window) attention, then grid (dilated) attention, each
attention layer pre-norm with a relative position bias
(``swin.WindowAttention``) and a 4x MLP; the head mean-pools, normalizes,
applies a tanh ``head_pre`` and the classifier.  The blocks compute in
``[B, H, W, C]``, as flax does.

- ``MaxViTTV`` (the default, ``variant="tv"``): torchvision's maxvit_t,
  the form behind the reference's MAXVIT class map.  MBConv with folded
  BatchNorm, SE squeeze = out // 4, the stride-2 shortcut an
  AvgPool2d(3, 2, padding 1) that counts its padding, attention scaled by
  feat_dim ** -0.5, a bias-free classifier.
- ``MaxViT`` (``variant="paper"``): the paper form, LayerNorm MBConv, SE
  squeeze = mid // 4, a VALID average-pool shortcut, head_dim ** -0.5.

Windows shrink to ``min(window, H, W)``; the window sizes, as the bias
tables' shapes, are fixed by ``img_hw`` at construction.  Submodule names
follow the JAX parameter tree (``stem_conv1``, ``stage{s}_block{b}.mbconv
.conv_a``, ``.window_attn.attn.rel_bias_table``, ``head_pre``, ...).

Counters (``utils/trace.py``), a model row at maxvit_t's 224 px:
``window_attn_rows`` 17,836 (``swin.WindowAttention`` counts the block
and the grid layers' groups x tokens alike: 2 x 3136 + 2 x 784 + 5 x 196 +
2 x 49 a layer kind); ``grid_attn_rows`` 8,918, the grid layers' share of
it; ``mbconv_rows`` 21,413, each MBConv's batch x input pixels, the
resolution its expansion, BN and GELU run at (12544 + 3136 in stage 0,
3136 + 784, 784 + 4 x 196, 196 + 49); ``mbconv_dense_rows`` the same
where the input is dense ``[B, H, W, C]`` memory, which it is on every
call: the forward makes the stem's input contiguous, the 1x1
convolutions run as GEMMs over the pixels, the 3x3 ones read and write
channels-last, and the shortcut's pool comes back dense.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..utils import trace
from .common import (FoldedBN, LayerNorm, ModelBundle, ModelMeta,
                     conv_nhwc, init_flax_default)
from .swin import WindowAttention, window_partition, window_reverse

# torchvision's maxvit_t, the ``MAXVIT`` bundle's form (``MaxViTTV``'s
# arguments)
TV_ARCH = dict(depths=(2, 2, 5, 2), dims=(64, 128, 256, 512), stem_dim=64,
               window=7, head_dim=32, num_classes=1000, img_hw=224)


def grid_partition(x, gs: int):
    """Grid (dilated) partition ``[B, H, W, C]`` -> ``[B * H/gs * W/gs,
    gs*gs, C]``: each group takes every (H/gs)-th pixel."""
    b, h, w, c = x.shape
    x = x.reshape(b, gs, h // gs, gs, w // gs, c)
    return x.permute(0, 2, 4, 1, 3, 5).reshape(-1, gs * gs, c)


def grid_reverse(wins, gs: int, b: int, h: int, w: int):
    c = wins.shape[-1]
    x = wins.reshape(b, h // gs, w // gs, gs, gs, c)
    return x.permute(0, 3, 1, 4, 2, 5).reshape(b, h, w, c)


class SqueezeExcite(nn.Module):
    """Mean-pool, ``fc1`` + SiLU, ``fc2`` + sigmoid, rescale: the paper
    form's squeeze is ``max(1, int(mid * 0.25))``, torchvision's an
    explicit ``sqz``."""

    def __init__(self, mid: int, sqz: int):
        super().__init__()
        self.fc1 = nn.Linear(mid, sqz)
        self.fc2 = nn.Linear(sqz, mid)

    def forward(self, x):
        s = F.silu(self.fc1(x.mean(dim=(1, 2))))
        return x * torch.sigmoid(self.fc2(s))[:, None, None, :]


def _pointwise(conv: nn.Conv2d, x):
    """A 1x1 convolution of a dense ``[B, H, W, C]`` batch as the GEMM it
    is over the pixels: one ``addmm`` with the bias.  cuDNN's float32
    channels-last path transposes to NCHW and back around its kernel
    (4.70 ms against this GEMM's 2.28 ms at [180, 64, 112, 112] to 256
    channels, on an H100)."""
    return F.linear(x, conv.weight.flatten(1), conv.bias)


def _pooled_shortcut(conv: nn.Module, x, *pool, **pool_kw):
    """``conv`` of the average pool of an ``[B, H, W, C]`` batch, returned
    dense ``[B, H', W', C']``.  The pool reads NCHW memory, a copy of
    ``x``: on CUDA, PyTorch's channels-last ``avg_pool2d`` backward gives
    a wrong input gradient for torchvision's padded 3x3 pool (0.94 of the
    largest off, on an H100 with torch 2.11; the paper form's 2x2 pool
    was right), and the NCHW forward kernel is the faster one."""
    x = F.avg_pool2d(x.permute(0, 3, 1, 2).contiguous(), *pool, **pool_kw)
    return conv(x).permute(0, 2, 3, 1).contiguous()


def _count_rows(x):
    """An MBConv input's batch x pixels into ``mbconv_rows``, and into
    ``mbconv_dense_rows`` where it is dense ``[B, H, W, C]`` memory."""
    rows = math.prod(x.shape[:-1])
    trace.count("mbconv_rows", rows)
    if x.is_contiguous():
        trace.count("mbconv_dense_rows", rows)


class MBConv(nn.Module):
    """Paper form: LayerNorm, 1x1 expand + GELU, 3x3 depthwise (stride) +
    GELU, SE, 1x1 project; the shortcut a VALID stride x stride average
    pool and a 1x1 conv where the stride or the width changes.  Counts
    its input's rows (:func:`_count_rows`)."""

    def __init__(self, cin: int, dim: int, stride: int = 1,
                 expansion: int = 4):
        super().__init__()
        mid = dim * expansion
        self.stride = stride
        self.pre_norm = LayerNorm(cin, eps=1e-5)
        self.expand = nn.Conv2d(cin, mid, 1)
        self.dw = nn.Conv2d(mid, mid, 3, stride=stride, padding=1,
                            groups=mid)
        self.se = SqueezeExcite(mid, max(1, int(mid * 0.25)))
        self.proj = nn.Conv2d(mid, dim, 1)
        self.shortcut = (nn.Conv2d(cin, dim, 1)
                         if stride > 1 or cin != dim else None)

    def forward(self, x):
        _count_rows(x)
        h = F.gelu(_pointwise(self.expand, self.pre_norm(x)))
        h = F.gelu(conv_nhwc(self.dw, h))
        h = _pointwise(self.proj, self.se(h))
        if self.stride > 1:
            x = _pooled_shortcut(self.shortcut, x, self.stride, self.stride)
        elif self.shortcut is not None:
            x = _pointwise(self.shortcut, x)
        return x + h


class MBConvTV(nn.Module):
    """torchvision's MBConv (eval): folded-BN pre-norm, ``conv_a`` 1x1 + BN
    + GELU, ``conv_b`` 3x3 depthwise (stride) + BN + GELU, SE (SiLU,
    squeeze dim // 4), ``conv_c`` 1x1 with bias; the stride-2 shortcut an
    AvgPool2d(3, 2, padding 1) counting its padding, then a 1x1 conv.
    Counts its input's rows (:func:`_count_rows`)."""

    def __init__(self, cin: int, dim: int, stride: int = 1,
                 expansion: int = 4):
        super().__init__()
        mid = dim * expansion
        self.stride = stride
        self.pre_norm = FoldedBN(cin, channels_last=True)
        self.conv_a = nn.Conv2d(cin, mid, 1, bias=False)
        self.bn_a = FoldedBN(mid, channels_last=True)
        self.conv_b = nn.Conv2d(mid, mid, 3, stride=stride, padding=1,
                                groups=mid, bias=False)
        self.bn_b = FoldedBN(mid, channels_last=True)
        self.se = SqueezeExcite(mid, dim // 4)
        self.conv_c = nn.Conv2d(mid, dim, 1)
        self.shortcut = (nn.Conv2d(cin, dim, 1)
                         if stride != 1 or cin != dim else None)

    def forward(self, x):
        _count_rows(x)
        h = F.gelu(self.bn_a(_pointwise(self.conv_a, self.pre_norm(x))))
        h = F.gelu(self.bn_b(conv_nhwc(self.conv_b, h)))
        h = _pointwise(self.conv_c, self.se(h))
        if self.stride == 2:
            x = _pooled_shortcut(self.shortcut, x, 3, 2, 1,
                                 count_include_pad=True)
        elif self.shortcut is not None:
            x = _pointwise(self.shortcut, x)
        return x + h


class AttnLayer(nn.Module):
    """Pre-norm window (``grid=False``) or grid attention and a pre-norm
    4x MLP, each with its skip, at a ``res`` x ``res`` grid.  A grid layer
    counts its groups x tokens a group (batch x pixels) into
    ``grid_attn_rows``."""

    def __init__(self, dim: int, num_heads: int, window: int, res: int,
                 grid: bool = False, scale: Optional[float] = None):
        super().__init__()
        self.ws = min(window, res)
        self.grid = grid
        self.norm = LayerNorm(dim, eps=1e-5)
        self.attn = WindowAttention(dim, num_heads, self.ws, scale=scale)
        self.mlp_norm = LayerNorm(dim, eps=1e-5)
        self.mlp_fc1 = nn.Linear(dim, 4 * dim)
        self.mlp_fc2 = nn.Linear(4 * dim, dim)

    def forward(self, x):
        b, h, w, _ = x.shape
        ws = self.ws
        y = self.norm(x)
        if self.grid:
            trace.count("grid_attn_rows", b * h * w)
            a = grid_reverse(self.attn(grid_partition(y, ws)), ws, b, h, w)
        else:
            a = window_reverse(self.attn(window_partition(y, ws)), ws, b, h,
                               w)
        x = x + a
        return x + self.mlp_fc2(F.gelu(self.mlp_fc1(self.mlp_norm(x))))


class MaxViTBlock(nn.Module):
    def __init__(self, cin: int, dim: int, num_heads: int, window: int,
                 stride: int, res: int, tv: bool):
        super().__init__()
        self.tv = tv
        if tv:
            scale = dim ** -0.5          # torchvision's feat_dim ** -0.5
            self.mbconv = MBConvTV(cin, dim, stride)
            self.window_attn = AttnLayer(dim, num_heads, window, res,
                                         scale=scale)
        else:
            scale = None
            self.mbconv = MBConv(cin, dim, stride)
            self.block_attn = AttnLayer(dim, num_heads, window, res)
        self.grid_attn = AttnLayer(dim, num_heads, window, res, grid=True,
                                   scale=scale)

    def forward(self, x):
        x = self.mbconv(x)
        x = self.window_attn(x) if self.tv else self.block_attn(x)
        return self.grid_attn(x)


class _MaxViTBase(nn.Module):
    """Both forms' stages and head; ``tv`` picks the form."""

    def __init__(self, tv: bool, depths: Sequence[int], dims: Sequence[int],
                 stem_dim: int, window: int, head_dim: int, num_classes: int,
                 img_hw: int):
        super().__init__()
        self.depths = tuple(depths)
        res = -(-img_hw // 2)                    # the stride-2 stem
        cin = stem_dim
        for s, (depth, dim) in enumerate(zip(depths, dims)):
            for b in range(depth):
                stride = 2 if b == 0 else 1
                res = -(-res // stride)
                setattr(self, f"stage{s}_block{b}", MaxViTBlock(
                    cin, dim, max(1, dim // head_dim), window, stride, res,
                    tv))
                cin = dim
        self.head_norm = LayerNorm(dims[-1], eps=1e-5)
        self.head_pre = nn.Linear(dims[-1], dims[-1])
        self.head = nn.Linear(dims[-1], num_classes, bias=not tv)

    def stem(self, x):
        raise NotImplementedError

    def forward(self, x, taps: bool = False):
        tap = {}
        # dense [B, H, W, C] from here on: the 1x1 convolutions are GEMMs
        # over the pixels, and the others convolve the channels-last NCHW
        # view, which cuDNN writes back channels-last; so every linear folds
        # to one GEMM and the LayerNorms can take the fused kernel
        y = self.stem(x.permute(0, 2, 3, 1).contiguous())
        for s, depth in enumerate(self.depths):
            for b in range(depth):
                y = getattr(self, f"stage{s}_block{b}")(y)
            tap[f"stage{s}"] = y.permute(0, 3, 1, 2)
        tap["layer4"] = tap[f"stage{len(self.depths) - 1}"]
        y = torch.tanh(self.head_pre(self.head_norm(y.mean(dim=(1, 2)))))
        logits = self.head(y)
        return (logits, tap) if taps else logits


class MaxViTTV(_MaxViTBase):
    """torchvision's maxvit_t: stem conv (no bias) + folded BN + GELU, then
    conv (bias)."""

    def __init__(self, depths: Sequence[int] = (2, 2, 5, 2),
                 dims: Sequence[int] = (64, 128, 256, 512),
                 stem_dim: int = 64, window: int = 7, head_dim: int = 32,
                 num_classes: int = 1000, img_hw: int = 224):
        super().__init__(True, depths, dims, stem_dim, window, head_dim,
                         num_classes, img_hw)
        self.stem_conv1 = nn.Conv2d(3, stem_dim, 3, stride=2, padding=1,
                                    bias=False)
        self.stem_bn = FoldedBN(stem_dim, channels_last=True)
        self.stem_conv2 = nn.Conv2d(stem_dim, stem_dim, 3, padding=1)

    def stem(self, x):
        y = F.gelu(self.stem_bn(conv_nhwc(self.stem_conv1, x)))
        return conv_nhwc(self.stem_conv2, y)


class MaxViT(_MaxViTBase):
    """The paper form: stem conv + GELU, then conv, both with bias; heads
    = dim // 32."""

    def __init__(self, depths: Sequence[int] = (2, 2, 5, 2),
                 dims: Sequence[int] = (64, 128, 256, 512),
                 stem_dim: int = 64, window: int = 7,
                 num_classes: int = 1000, img_hw: int = 224):
        super().__init__(False, depths, dims, stem_dim, window, 32,
                         num_classes, img_hw)
        self.stem1 = nn.Conv2d(3, stem_dim, 3, stride=2, padding=1)
        self.stem2 = nn.Conv2d(stem_dim, stem_dim, 3, padding=1)

    def stem(self, x):
        return conv_nhwc(self.stem2, F.gelu(conv_nhwc(self.stem1, x)))


def make_bundle(state: Optional[dict] = None, seed: int = 0,
                batch_size: int = 25, variant: str = "tv",
                device=None) -> ModelBundle:
    """The MAXVIT bundle at 224 px: ``variant="tv"`` (the default) is
    torchvision's form at ``TV_ARCH``, ``"paper"`` the paper's; seeded
    random weights in flax's scheme, or ``state``, on ``device``."""
    model = MaxViTTV(**TV_ARCH) if variant == "tv" else MaxViT()
    init_flax_default(model, seed)
    if state is not None:
        model.load_state_dict(state)
    meta = ModelMeta(name="MAXVIT", family="cnn", batch_size=batch_size)
    return ModelBundle(meta, model.to(device))
