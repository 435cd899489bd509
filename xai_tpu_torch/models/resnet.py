"""ResNet / ResNeXt (+ wide) family with stage taps, as ``nn.Module``s.

Counterpart of ``xai_tpu/models/resnet.py``, in NCHW.  Submodule names
follow the JAX parameter tree (``conv1``, ``bn1``, ``layerN[b]``,
``downsample_conv``, ``fc``) so the weight carry in ``convert/from_jax.py``
is a renaming plus a layout transpose.

Inference BatchNorm is folded into a per-channel ``x * scale + bias``
(``FoldedBN``), exactly as the JAX model stores it.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from .common import lecun_init_


class FoldedBN(nn.Module):
    """Inference BatchNorm as y = x * scale + bias (per channel)."""

    def __init__(self, features: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x):
        return x * self.scale[:, None, None] + self.bias[:, None, None]


def _conv(cin, cout, k, stride=1, padding=0, groups=1):
    return nn.Conv2d(cin, cout, k, stride=stride, padding=padding,
                     groups=groups, bias=False)


class Bottleneck(nn.Module):
    """torchvision-style bottleneck: conv1x1-bn-relu, conv3x3(stride,
    groups)-bn-relu, conv1x1-bn, + skip, relu."""

    def __init__(self, in_features: int, width: int, out_features: int,
                 stride: int = 1, groups: int = 1,
                 relu: Callable = F.relu):
        super().__init__()
        self.relu = relu
        self.conv1 = _conv(in_features, width, 1)
        self.bn1 = FoldedBN(width)
        self.conv2 = _conv(width, width, 3, stride, 1, groups)
        self.bn2 = FoldedBN(width)
        self.conv3 = _conv(width, out_features, 1)
        self.bn3 = FoldedBN(out_features)
        self.downsample_conv = self.downsample_bn = None
        if in_features != out_features or stride != 1:
            # JAX's 1x1 stride-2 'SAME' conv pads nothing at these sizes
            self.downsample_conv = _conv(in_features, out_features, 1, stride)
            self.downsample_bn = FoldedBN(out_features)

    def forward(self, x):
        y = self.relu(self.bn1(self.conv1(x)))
        y = self.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        residual = x
        if self.downsample_conv is not None:
            residual = self.downsample_bn(self.downsample_conv(x))
        return self.relu(y + residual)


class ResNet(nn.Module):
    """ResNet-(50|101|152) / ResNeXt with stage taps.

    ``forward(x)`` returns logits; ``taps=True`` also returns
    {"layer1".."layer4": stage activations NCHW, "pool": pooled features}.
    ``relu`` is the activation of the stem and of every block, the
    counterpart of the flax model's ``relu`` field (:func:`set_relu`
    swaps it, e.g. for guided backprop's rule).
    """

    def __init__(self, layers: Sequence[int], num_classes: int = 1000,
                 groups: int = 1, width_per_group: int = 64,
                 relu: Callable = F.relu):
        super().__init__()
        self.relu = relu
        self.conv1 = _conv(3, 64, 7, 2, 3)
        self.bn1 = FoldedBN(64)
        # JAX pads with -inf, then a VALID 3x3/2 max-pool: the same thing
        self.maxpool = nn.MaxPool2d(3, 2, padding=1)
        in_features = 64
        for stage, (planes, blocks) in enumerate(zip((64, 128, 256, 512),
                                                     layers)):
            width = int(planes * (width_per_group / 64.0)) * groups
            out_features = planes * 4
            stage_blocks = []
            for b in range(blocks):
                stride = 2 if (stage > 0 and b == 0) else 1
                stage_blocks.append(Bottleneck(in_features, width,
                                               out_features, stride, groups,
                                               relu))
                in_features = out_features
            setattr(self, f"layer{stage + 1}", nn.Sequential(*stage_blocks))
        self.fc = nn.Linear(in_features, num_classes)

    def forward(self, x, taps: bool = False, probes: Optional[dict] = None):
        """``probes``: optional dict of zero tensors added to stage outputs;
        the gradient with respect to a probe is the gradient with respect
        to that activation."""
        tap = {}
        y = self.maxpool(self.relu(self.bn1(self.conv1(x))))
        for name in ("layer1", "layer2", "layer3", "layer4"):
            y = getattr(self, name)(y)
            if probes is not None and name in probes:
                y = y + probes[name]
            tap[name] = y
        y = y.mean(dim=(2, 3))
        tap["pool"] = y
        logits = self.fc(y)
        if taps:
            return logits, tap
        return logits


ARCHS = {
    "resnet50": dict(layers=(3, 4, 6, 3)),
    "resnet101": dict(layers=(3, 4, 23, 3)),
    "resnet152": dict(layers=(3, 8, 36, 3)),
    "resnext50_32x4d": dict(layers=(3, 4, 6, 3), groups=32, width_per_group=4),
    "resnext101_32x8d": dict(layers=(3, 4, 23, 3), groups=32, width_per_group=8),
    "resnext101_64x4d": dict(layers=(3, 4, 23, 3), groups=64, width_per_group=4),
    "wide_resnet50_2": dict(layers=(3, 4, 6, 3), width_per_group=128),
    "wide_resnet101_2": dict(layers=(3, 4, 23, 3), width_per_group=128),
}

# registry names used by the reference CLI (evaluatePerturbation.py:627-647)
CLI_ARCH = {"R50": "resnet50", "R101": "resnet101", "R152": "resnet152",
            "RNXT": "resnext101_64x4d"}


def make_model(arch: str, num_classes: int = 1000) -> ResNet:
    return ResNet(num_classes=num_classes, **ARCHS[arch])


def set_relu(model: nn.Module, relu: Callable) -> nn.Module:
    """Give the stem and every block of ``model`` the activation ``relu``
    (in place), the counterpart of flax's ``model.clone(relu=...)``."""
    for m in model.modules():
        if isinstance(m, (ResNet, Bottleneck)):
            m.relu = relu
    return model


def init_random(model: nn.Module, seed: int = 0) -> nn.Module:
    """Seeded random weights in flax's default scheme (truncated-normal
    LeCun kernels, zero dense bias, identity FoldedBN).  The numbers differ
    from JAX's PRNG; tests that compare the two packages carry the JAX
    weights over instead."""
    return lecun_init_(model, torch.Generator(device="cpu").manual_seed(seed))

