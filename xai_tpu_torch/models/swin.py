"""Swin Transformer (tiny/small/base) with taps, as ``nn.Module``s.

Counterpart of ``xai_tpu/models/swin.py``: a 4x4 stride-4 patch embedding
(XLA ``"SAME"`` padding), windowed attention with a relative position
bias, shifted windows on every second block, patch merging (x0, x1, x2,
x3 concatenated in xai_tpu's order), LayerNorm (eps 1e-5) and a mean-pool
head.  The blocks compute in ``[B, H, W, C]``, as flax does.

A window shrinks to ``min(window, H, W)``, and a block's shift is dropped
when its window covers the grid (the last stage at 224 px).  The window
sizes, shift masks and relative position indices are fixed by the input
size given at construction (``img_hw``), as flax fixes the bias table's
shape at init; they are buffers kept out of the state dict.

Submodule names follow the JAX parameter tree (``patch_embed``,
``stage{s}_block{b}.attn.qkv``, ``.attn.rel_bias_table``,
``merge{s}.reduction``, ``norm``, ``head``, ...).

Every call of :class:`WindowAttention` adds its query rows, windows times
tokens a window, to the counter ``window_attn_rows`` (``utils/trace.py``),
and a call that carries a shift mask adds them to ``masked_window_rows``
too: a Swin block's attention, shifted or not, and MaxViT's block and grid
attention, which share the module (``models/maxvit.py``).  Swin-B at
224 px counts 11,466 rows an image, 5,684 of them masked: the last stage's
shift is dropped.

Part spans (``utils/trace.py``): the patch embedding a ``conv`` part; the
rolls with the window partition, the window reverse with the roll back,
patch merging's gather and the patch norm's input copy ``layout`` parts;
qkv, the projection, the MLP's linears, the merging's reduction and the
head ``linear`` parts; :class:`WindowAttention` between qkv and the
projection (the bias gather and add, the mask, softmax) one ``attn``
part; every LayerNorm a ``norm`` part; GELU, the residual adds and the
mean-pool ``pointwise`` parts.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn as nn

from ..utils import trace
from .common import (Conv2dSame, LayerNorm, ModelBundle, ModelMeta,
                     conv_nhwc, init_flax_default, linear, mlp)


def rel_position_index(ws: int) -> np.ndarray:
    """``[ws*ws, ws*ws]`` index of each (query, key) pair's offset into the
    ``(2 ws - 1)^2`` rows of the relative bias table."""
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws),
                                  indexing="ij"))          # [2, ws, ws]
    flat = coords.reshape(2, -1)
    rel = (flat[:, :, None] - flat[:, None, :]).transpose(1, 2, 0)
    rel[:, :, 0] += ws - 1
    rel[:, :, 1] += ws - 1
    rel[:, :, 0] *= 2 * ws - 1
    return rel.sum(-1)


def window_partition(x, ws: int):
    """``[B, H, W, C]`` -> ``[B * H/ws * W/ws, ws*ws, C]`` windows."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // ws, ws, w // ws, ws, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, ws * ws, c)


def window_reverse(wins, ws: int, b: int, h: int, w: int):
    c = wins.shape[-1]
    x = wins.reshape(b, h // ws, w // ws, ws, ws, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h, w, c)


def shift_mask(h: int, w: int, ws: int, shift: int) -> np.ndarray:
    """``[nW, ws*ws, ws*ws]``: -100 between positions of different regions
    of the shifted grid, 0 within one (torchvision's attn_mask)."""
    img = np.zeros((h, w))
    cnt = 0
    for hs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for wss in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img[hs, wss] = cnt
            cnt += 1
    wins = img.reshape(h // ws, ws, w // ws, ws).transpose(0, 2, 1, 3)
    wins = wins.reshape(-1, ws * ws)
    mask = wins[:, None, :] - wins[:, :, None]
    return np.where(mask != 0, -100.0, 0.0).astype(np.float32)


class WindowAttention(nn.Module):
    """Multi-head attention within windows, with a learned relative
    position bias, in the compute dtype: logits ``(q @ k^T) * scale``
    (the scale after the product), bias, optional mask, softmax, ``@ v``.
    ``scale`` None is head_dim ** -0.5 (Swin); MaxViT's torchvision form
    passes feat_dim ** -0.5.  Each call counts its ``nW * N`` query rows
    into ``window_attn_rows``, and into ``masked_window_rows`` where it
    has a mask."""

    def __init__(self, dim: int, num_heads: int, window: int,
                 scale: Optional[float] = None):
        super().__init__()
        self.num_heads = num_heads
        hd = dim // num_heads
        self.scale = hd ** -0.5 if scale is None else scale
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        self.rel_bias_table = nn.Parameter(
            torch.zeros((2 * window - 1) ** 2, num_heads))
        self.register_buffer("rel_index", torch.as_tensor(
            rel_position_index(window).reshape(-1)), persistent=False)

    def forward(self, x, mask=None):
        """x: ``[nW, N, C]`` windows; mask: ``[nm, N, N]`` or None."""
        nw, n, c = x.shape
        h = self.num_heads
        trace.count("window_attn_rows", nw * n)
        if mask is not None:
            trace.count("masked_window_rows", nw * n)
        qkv = linear(self.qkv, x)
        with trace.part("attn", qkv):
            qkv = qkv.view(nw, n, 3, h, c // h)
            q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
            attn = (q @ k.transpose(-2, -1)) * self.scale
            bias = self.rel_bias_table[self.rel_index].view(n, n, h)
            attn = attn + bias.permute(2, 0, 1)[None]
            if mask is not None:
                nm = mask.shape[0]
                attn = attn.view(nw // nm, nm, h, n, n) + \
                    mask.to(attn.dtype)[None, :, None]
                attn = attn.view(nw, h, n, n)
            attn = torch.softmax(attn, dim=-1).to(x.dtype)
            out = (attn @ v).transpose(1, 2).reshape(nw, n, c)
        return linear(self.proj, out)


class SwinBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, window: int, shift: int,
                 res: int):
        super().__init__()
        self.ws = ws = min(window, res)
        self.shift = 0 if ws >= res and shift else shift
        self.norm1 = LayerNorm(dim, eps=1e-5)
        self.attn = WindowAttention(dim, num_heads, ws)
        self.norm2 = LayerNorm(dim, eps=1e-5)
        self.mlp_fc1 = nn.Linear(dim, 4 * dim)
        self.mlp_fc2 = nn.Linear(4 * dim, dim)
        self.register_buffer("mask", torch.as_tensor(
            shift_mask(res, res, ws, self.shift)) if self.shift else None,
            persistent=False)

    def forward(self, x):
        b, h, w, _ = x.shape
        s = self.shift
        y = self.norm1(x)
        with trace.part("layout", y):
            if s:
                y = torch.roll(y, (-s, -s), dims=(1, 2))
            y = window_partition(y, self.ws)
        a = self.attn(y, self.mask)
        with trace.part("layout", a):
            a = window_reverse(a, self.ws, b, h, w)
            if s:
                a = torch.roll(a, (s, s), dims=(1, 2))
        with trace.part("pointwise", a):
            x = x + a
        m = mlp(self.mlp_fc1, self.mlp_fc2, self.norm2(x))
        with trace.part("pointwise", m):
            return x + m


class PatchMerging(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.norm = LayerNorm(4 * dim, eps=1e-5)
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)

    def forward(self, x):
        with trace.part("layout", x):
            y = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2],
                           x[:, 0::2, 1::2], x[:, 1::2, 1::2]], dim=-1)
        return linear(self.reduction, self.norm(y))


class SwinTransformer(nn.Module):
    """``forward(x)`` takes NCHW at ``img_hw`` and returns logits;
    ``taps=True`` also returns {"stage0".."stage3", "layer4": each
    stage's output}, NCHW."""

    def __init__(self, depths: Sequence[int] = (2, 2, 6, 2),
                 num_heads: Sequence[int] = (3, 6, 12, 24),
                 embed_dim: int = 96, window: int = 7,
                 num_classes: int = 1000, img_hw: int = 224):
        super().__init__()
        self.depths = tuple(depths)
        self.patch_embed = Conv2dSame(3, embed_dim, 4, stride=4)
        self.patch_norm = LayerNorm(embed_dim, eps=1e-5)
        dim, res = embed_dim, -(-img_hw // 4)
        for s, (depth, heads) in enumerate(zip(depths, num_heads)):
            if s > 0:
                setattr(self, f"merge{s}", PatchMerging(dim))
                dim, res = 2 * dim, res // 2
            for b in range(depth):
                setattr(self, f"stage{s}_block{b}", SwinBlock(
                    dim, heads, window, 0 if b % 2 == 0 else window // 2,
                    res))
        self.norm = LayerNorm(dim, eps=1e-5)
        self.head = nn.Linear(dim, num_classes)

    @trace.tiled
    def forward(self, x, taps: bool = False):
        tap = {}
        y = conv_nhwc(self.patch_embed, x.permute(0, 2, 3, 1))
        if y.is_cuda and not torch.is_grad_enabled():
            # the NHWC rows in memory order, so that the patch norm takes
            # the fused LayerNorm: one copy and one pass in place of its
            # separate ops over a strided view
            with trace.part("layout", y):
                y = y.contiguous()
        y = self.patch_norm(y)
        for s, depth in enumerate(self.depths):
            if s > 0:
                y = getattr(self, f"merge{s}")(y)
            for b in range(depth):
                y = getattr(self, f"stage{s}_block{b}")(y)
            tap[f"stage{s}"] = y.permute(0, 3, 1, 2)
        tap["layer4"] = tap[f"stage{len(self.depths) - 1}"]
        y = self.norm(y)
        with trace.part("pointwise", y):
            y = y.mean(dim=(1, 2))
        logits = linear(self.head, y)
        return (logits, tap) if taps else logits


ARCHS = {
    "swin_tiny": dict(depths=(2, 2, 6, 2), num_heads=(3, 6, 12, 24),
                      embed_dim=96),
    "swin_small": dict(depths=(2, 2, 18, 2), num_heads=(3, 6, 12, 24),
                       embed_dim=96),
    "swin_base": dict(depths=(2, 2, 18, 2), num_heads=(4, 8, 16, 32),
                      embed_dim=128),
}


def make_bundle(arch: str = "swin_tiny", state: Optional[dict] = None,
                seed: int = 0, batch_size: int = 25,
                device=None) -> ModelBundle:
    """The bundle of a Swin arch at 224 px: seeded random weights in
    flax's scheme, or ``state``, on ``device``."""
    model = init_flax_default(
        SwinTransformer(num_classes=1000, **ARCHS[arch]), seed)
    if state is not None:
        model.load_state_dict(state)
    meta = ModelMeta(name=arch, family="cnn", batch_size=batch_size)
    return ModelBundle(meta, model.to(device))
