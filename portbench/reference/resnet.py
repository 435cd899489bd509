"""Plain ResNet forward (He et al. 2016; torchvision's ``resnet101`` v1.5
layout: the stride of a stage's first block on its 3x3 convolution).

Float32, plain ``torch`` operations over a dict of weights keyed by the
names of the program's state dict, so the benchmark can hand both sides
one set.  Inference BatchNorm is a per-channel ``x * scale + bias``.
Imports nothing of the program.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

STAGE_PLANES = (64, 128, 256, 512)
EXPANSION = 4


def blocks(cfg: dict):
    """``(prefix, in, width, out, stride)`` of every bottleneck block."""
    cin = cfg["stem_width"]
    for s, (planes, n) in enumerate(zip(STAGE_PLANES, cfg["layers"])):
        for b in range(n):
            out = planes * EXPANSION
            yield (f"layer{s + 1}.{b}.", cin, planes, out,
                   2 if s > 0 and b == 0 else 1)
            cin = out


def param_spec(cfg: dict) -> list:
    """``[(name, shape, kind)]`` of every weight; ``kind`` names the
    benchmark's init rule (``portbench/weights.py``)."""
    spec = [("conv1.weight", (cfg["stem_width"], 3, 7, 7), "conv"),
            ("bn1.scale", (cfg["stem_width"],), "scale"),
            ("bn1.bias", (cfg["stem_width"],), "shift")]
    for pre, cin, width, out, stride in blocks(cfg):
        spec += [(pre + "conv1.weight", (width, cin, 1, 1), "conv"),
                 (pre + "bn1.scale", (width,), "scale"),
                 (pre + "bn1.bias", (width,), "shift"),
                 (pre + "conv2.weight", (width, width, 3, 3), "conv"),
                 (pre + "bn2.scale", (width,), "scale"),
                 (pre + "bn2.bias", (width,), "shift"),
                 (pre + "conv3.weight", (out, width, 1, 1), "conv"),
                 (pre + "bn3.scale", (out,), "branch_scale"),
                 (pre + "bn3.bias", (out,), "shift")]
        if cin != out or stride != 1:
            spec += [(pre + "downsample_conv.weight", (out, cin, 1, 1),
                      "conv"),
                     (pre + "downsample_bn.scale", (out,), "scale"),
                     (pre + "downsample_bn.bias", (out,), "shift")]
    feat = STAGE_PLANES[-1] * EXPANSION
    spec += [("fc.weight", (cfg["num_classes"], feat), "head"),
             ("fc.bias", (cfg["num_classes"],), "zero")]
    return spec


def _bn(w, name, x):
    return x * w[name + ".scale"][:, None, None] + w[name + ".bias"][:, None,
                                                                     None]


def forward(w: dict, cfg: dict, x: torch.Tensor) -> torch.Tensor:
    """``[N, 3, H, W]`` -> logits ``[N, classes]``."""
    y = F.relu(_bn(w, "bn1", F.conv2d(x, w["conv1.weight"], stride=2,
                                      padding=3)))
    y = F.max_pool2d(y, 3, 2, padding=1)
    for pre, cin, width, out, stride in blocks(cfg):
        h = F.relu(_bn(w, pre + "bn1", F.conv2d(y, w[pre + "conv1.weight"])))
        h = F.relu(_bn(w, pre + "bn2", F.conv2d(h, w[pre + "conv2.weight"],
                                               stride=stride, padding=1)))
        h = _bn(w, pre + "bn3", F.conv2d(h, w[pre + "conv3.weight"]))
        if pre + "downsample_conv.weight" in w:
            y = _bn(w, pre + "downsample_bn",
                    F.conv2d(y, w[pre + "downsample_conv.weight"],
                             stride=stride))
        y = F.relu(h + y)
    return y.mean(dim=(2, 3)) @ w["fc.weight"].T + w["fc.bias"]


def macs(cfg: dict) -> int:
    """Multiply-accumulates of one forward at ``cfg['img_hw']``: every
    convolution (k*k*cin MACs an output element) and the head."""
    hw = cfg["img_hw"]
    size = (hw + 2 * 3 - 7) // 2 + 1                  # stem, stride 2
    total = size * size * cfg["stem_width"] * 3 * 49
    size = (size + 2 - 3) // 2 + 1                    # max-pool
    for pre, cin, width, out, stride in blocks(cfg):
        o = (size - 1) // stride + 1
        total += size * size * width * cin             # 1x1
        total += o * o * width * width * 9             # 3x3, stride
        total += o * o * out * width                   # 1x1
        if cin != out or stride != 1:
            total += o * o * out * cin                 # downsample
        size = o
    return total + cfg["num_classes"] * STAGE_PLANES[-1] * EXPANSION
