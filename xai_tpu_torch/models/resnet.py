"""ResNet / ResNeXt (+ wide) family with stage taps, as ``nn.Module``s.

Counterpart of ``xai_tpu/models/resnet.py``, in NCHW.  Submodule names
follow the JAX parameter tree (``conv1``, ``bn1``, ``layerN[b]``,
``downsample_conv``, ``fc``) so the weight carry in ``convert/from_jax.py``
is a renaming plus a layout transpose.

Inference BatchNorm is folded into a per-channel ``x * scale + bias``
(``FoldedBN``), exactly as the JAX model stores it.  A forward that
records no autograd graph, on a contiguous CUDA float32 input with
``F.relu`` as its activation, runs each convolution's epilogue (FoldedBN,
the residual with its downsample FoldedBN, ReLU) as one pass of
``kernels/bn_act.py``, bit-exact with the separate ops it replaces.

Part spans (``utils/trace.py``): each convolution a ``conv`` part, each
epilogue a ``norm`` part whichever way it runs, the max-pool, the probes
and the final mean ``pointwise`` parts, the classifier a ``linear`` part.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..kernels.bn_act import bn_act
from ..utils import trace
from .common import FoldedBN, ModelBundle, ModelMeta, lecun_init_, linear


def _conv(cin, cout, k, stride=1, padding=0, groups=1):
    return nn.Conv2d(cin, cout, k, stride=stride, padding=padding,
                     groups=groups, bias=False)


def _conv_part(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    with trace.part("conv", x):
        return conv(x)


def _fused(x: torch.Tensor, relu: Callable) -> bool:
    """Whether a module's forward on ``x`` takes the fused epilogue: no
    autograd graph is recorded (the kernel has no backward), ``x`` is a
    contiguous CUDA float32 tensor (so is every convolution's output
    after it), and the activation is ``F.relu`` (guided backprop's rule
    is not)."""
    return (relu is F.relu and not torch.is_grad_enabled() and x.is_cuda
            and x.dtype == torch.float32 and x.is_contiguous())


def _epilogue(fused: bool, relu: Callable, y: torch.Tensor, bn: FoldedBN,
              residual: Optional[torch.Tensor] = None,
              residual_bn: Optional[FoldedBN] = None) -> torch.Tensor:
    """``relu(bn(y) [+ residual_bn(residual), or + residual])``: one
    ``bn_act`` pass where ``fused``, else the separate ops; one ``norm``
    part either way."""
    with trace.part("norm", y):
        if fused:
            rest = () if residual is None else (residual,)
            if residual_bn is not None:
                rest += (residual_bn.scale, residual_bn.bias)
            return bn_act(y, bn.scale, bn.bias, *rest)
        y = bn(y)
        if residual is not None:
            y = y + (residual if residual_bn is None
                     else residual_bn(residual))
        return relu(y)


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
        fused = _fused(x, self.relu)
        y = _epilogue(fused, self.relu, _conv_part(self.conv1, x), self.bn1)
        y = _epilogue(fused, self.relu, _conv_part(self.conv2, y), self.bn2)
        y = _conv_part(self.conv3, y)
        if self.downsample_conv is None:
            return _epilogue(fused, self.relu, y, self.bn3, x)
        return _epilogue(fused, self.relu, y, self.bn3,
                         _conv_part(self.downsample_conv, x),
                         self.downsample_bn)


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

    @trace.tiled
    def forward(self, x, taps: bool = False, probes: Optional[dict] = None):
        """``probes``: optional dict of zero tensors added to stage outputs;
        the gradient with respect to a probe is the gradient with respect
        to that activation."""
        tap = {}
        fused = _fused(x, self.relu)
        if fused:
            trace.count("bn_act_rows", x.shape[0])
        y = _epilogue(fused, self.relu, _conv_part(self.conv1, x), self.bn1)
        with trace.part("pointwise", y):
            y = self.maxpool(y)
        for name in ("layer1", "layer2", "layer3", "layer4"):
            y = getattr(self, name)(y)
            if probes is not None and name in probes:
                with trace.part("pointwise", y):
                    y = y + probes[name]
            tap[name] = y
        with trace.part("pointwise", y):
            y = y.mean(dim=(2, 3))
        tap["pool"] = y
        logits = linear(self.fc, y)
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


def make_bundle(arch_or_cli: str, state: Optional[dict] = None,
                seed: int = 0, batch_size: int = 50,
                device=None) -> ModelBundle:
    """The bundle of a ResNet arch or CLI name: seeded random weights
    (:func:`init_random`), or ``state`` (the port's state dict), on
    ``device``."""
    model = init_random(make_model(CLI_ARCH.get(arch_or_cli, arch_or_cli)),
                        seed)
    if state is not None:
        model.load_state_dict(state)
    meta = ModelMeta(name=arch_or_cli, family="cnn", batch_size=batch_size)
    return ModelBundle(meta, model.to(device))
