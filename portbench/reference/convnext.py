"""Plain ConvNeXt forward (Liu et al. 2022, arXiv:2201.03545), in the form
of torchvision's ``convnext_base``: a ``patch_size`` x ``patch_size`` stem
convolution of that stride, then LayerNorm over the channels; stages of
blocks at widths ``dims``, each stage after the first entered through a
LayerNorm and a 2x2 stride-2 convolution; mean pool, LayerNorm, a linear
head.

Block (torchvision's ``CNBlock``): a ``kernel`` x ``kernel`` depthwise
convolution (padding ``kernel // 2``), then, on the channels-last
permute, LayerNorm (eps ``eps``), a linear to ``mlp_ratio`` x width,
exact GELU, a linear back, the per-channel layer scale ``gamma``; the
permute back and the skip.  Stochastic depth is the identity at
inference and is left out.

Departures from the program's arithmetic, none from its result beyond
float32 rounding:
- ``F.layer_norm`` computes the variance in two passes, where the
  program's LayerNorm takes flax's fast variance max(0, E[x^2] - E[x]^2);
- the stem and the downsampling convolutions pad nothing: the program's
  pad as XLA's ``"SAME"`` does, which at a side their stride divides
  (every side of a 224 px or 32 px input) is no padding.

NCHW tensors and ``F.conv2d``, float32, plain ``torch`` operations over a
dict of weights keyed by the names of the program's state dict.  Imports
nothing of the program.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .swin import _lin


def stages(cfg: dict):
    """``(stage, depth, width in, width, side)`` of every stage: the side
    of its blocks' grid; ``width in`` the previous stage's width (the
    downsampling's input), or None for the first."""
    side = cfg["img_hw"] // cfg["patch_size"]
    cin = None
    for s, (depth, dim) in enumerate(zip(cfg["depths"], cfg["dims"])):
        if s > 0:
            side //= 2
        yield s, depth, cin, dim, side
        cin = dim


def param_spec(cfg: dict) -> list:
    """``[(name, shape, kind)]`` of every weight; ``kind`` names the
    benchmark's init rule (``portbench/weights.py``).  Every bias but the
    head's is a ``shift`` and every LayerNorm scale 1: with zero biases
    the zero image (IG's first row) leaves every activation 0 and the
    input gradient overflows through the LayerNorms in series.  The layer
    scale ``gamma`` is ``branch_scale``: at torchvision's and flax's
    init of 1e-6 every block would be the identity."""
    p, k, r = cfg["patch_size"], cfg["kernel"], cfg["mlp_ratio"]
    c0 = cfg["dims"][0]
    spec = [("stem_conv.weight", (c0, 3, p, p), "conv"),
            ("stem_conv.bias", (c0,), "shift"),
            ("stem_norm.scale", (c0,), "one"),
            ("stem_norm.bias", (c0,), "shift")]
    for s, depth, cin, d, _ in stages(cfg):
        if cin is not None:
            spec += [(f"down{s}_norm.scale", (cin,), "one"),
                     (f"down{s}_norm.bias", (cin,), "shift"),
                     (f"down{s}_conv.weight", (d, cin, 2, 2), "conv"),
                     (f"down{s}_conv.bias", (d,), "shift")]
        hidden = int(r * d)
        for b in range(depth):
            n = f"stage{s}_block{b}."
            spec += [(n + "dwconv.weight", (d, 1, k, k), "conv"),
                     (n + "dwconv.bias", (d,), "shift"),
                     (n + "norm.scale", (d,), "one"),
                     (n + "norm.bias", (d,), "shift"),
                     (n + "pw1.weight", (hidden, d), "linear"),
                     (n + "pw1.bias", (hidden,), "shift"),
                     (n + "pw2.weight", (d, hidden), "linear"),
                     (n + "pw2.bias", (d,), "shift"),
                     (n + "gamma", (d,), "branch_scale")]
    d = cfg["dims"][-1]
    return spec + [("head_norm.scale", (d,), "one"),
                   ("head_norm.bias", (d,), "shift"),
                   ("head.weight", (cfg["num_classes"], d), "head"),
                   ("head.bias", (cfg["num_classes"],), "zero")]


def _ln(w, name, x, eps):
    """LayerNorm over the last axis."""
    return F.layer_norm(x, x.shape[-1:], w[name + ".scale"],
                        w[name + ".bias"], eps)


def _ln2d(w, name, x, eps):
    """LayerNorm over the channels of ``[B, C, H, W]`` (torchvision's
    ``LayerNorm2d``: a permute each way)."""
    return _ln(w, name, x.permute(0, 2, 3, 1), eps).permute(0, 3, 1, 2)


def block(w, n, x, cfg):
    """One ``CNBlock`` of ``[B, C, H, W]``, prefix ``n``."""
    k = cfg["kernel"]
    h = F.conv2d(x, w[n + "dwconv.weight"], w[n + "dwconv.bias"],
                 padding=k // 2, groups=x.shape[1])
    h = _ln(w, n + "norm", h.permute(0, 2, 3, 1), cfg["eps"])
    h = _lin(w, n + "pw2", F.gelu(_lin(w, n + "pw1", h)))
    return x + (w[n + "gamma"] * h).permute(0, 3, 1, 2)


def forward(w: dict, cfg: dict, x: torch.Tensor) -> torch.Tensor:
    """``[N, 3, H, W]`` -> logits ``[N, classes]``."""
    eps, p = cfg["eps"], cfg["patch_size"]
    y = _ln2d(w, "stem_norm", F.conv2d(x, w["stem_conv.weight"],
                                       w["stem_conv.bias"], stride=p), eps)
    for s, depth, cin, _, _ in stages(cfg):
        if cin is not None:
            y = F.conv2d(_ln2d(w, f"down{s}_norm", y, eps),
                         w[f"down{s}_conv.weight"], w[f"down{s}_conv.bias"],
                         stride=2)
        for b in range(depth):
            y = block(w, f"stage{s}_block{b}.", y, cfg)
    return _lin(w, "head", _ln(w, "head_norm", y.mean(dim=(2, 3)), eps))


def macs(cfg: dict) -> int:
    """Multiply-accumulates of one forward: the stem's convolution; per
    block the depthwise ``kernel`` x ``kernel`` and the MLP's two
    products at every pixel; each downsampling's 2x2 convolution; the
    head.  The norms, GELU, the layer scale, the skips and the pool are
    not MACs."""
    p, k = cfg["patch_size"], cfg["kernel"]
    side = cfg["img_hw"] // p
    total = side * side * cfg["dims"][0] * 3 * p * p
    for _, depth, cin, d, side in stages(cfg):
        t, hidden = side * side, int(cfg["mlp_ratio"] * d)
        if cin is not None:
            total += t * cin * d * 4
        total += depth * (t * d * k * k + 2 * t * d * hidden)
    return total + cfg["dims"][-1] * cfg["num_classes"]
