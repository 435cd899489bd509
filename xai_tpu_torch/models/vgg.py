"""VGG-(11|13|16|19) with taps, as ``nn.Module``s.

Counterpart of ``xai_tpu/models/vgg.py``, in NCHW: 3x3 convs padded by 1,
each followed by ReLU, VALID 2x2 max pools, the flattened features (NCHW
order, as torchvision and xai_tpu flatten them) through three dense
layers.  Submodule names follow the JAX parameter tree (``conv{i}``,
``fc0``..``fc2``), so the weight carry of ``convert/from_jax.py`` is a
rename and a transpose.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch.nn as nn
import torch.nn.functional as F

from .common import ModelBundle, ModelMeta, init_flax_default

# torchvision cfgs: number = conv out-channels, "M" = maxpool
CFGS = {
    "vgg11": (64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"),
    "vgg13": (64, 64, "M", 128, 128, "M", 256, 256, "M", 512, 512, "M",
              512, 512, "M"),
    "vgg16": (64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512,
              "M", 512, 512, 512, "M"),
    "vgg19": (64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
              512, 512, 512, 512, "M", 512, 512, 512, 512, "M"),
}


class VGG(nn.Module):
    """``forward(x)`` returns logits; ``taps=True`` also returns
    {"pool1".."poolK": each max pool's output, "features": the last
    one}, NCHW."""

    def __init__(self, cfg: Sequence, num_classes: int = 1000,
                 hidden: int = 4096, img_hw: int = 224):
        super().__init__()
        self.cfg = tuple(cfg)
        cin, hw, n = 3, img_hw, 0
        for c in self.cfg:
            if c == "M":
                hw //= 2
            else:
                setattr(self, f"conv{n}", nn.Conv2d(cin, c, 3, padding=1))
                cin, n = c, n + 1
        self.n_convs = n
        self.fc0 = nn.Linear(cin * hw * hw, hidden)
        self.fc1 = nn.Linear(hidden, hidden)
        self.fc2 = nn.Linear(hidden, num_classes)

    def forward(self, x, taps: bool = False):
        tap = {}
        n = stage = 0
        for c in self.cfg:
            if c == "M":
                x = F.max_pool2d(x, 2, 2)
                stage += 1
                tap[f"pool{stage}"] = x
            else:
                x = F.relu(getattr(self, f"conv{n}")(x))
                n += 1
        tap["features"] = x
        x = F.relu(self.fc0(x.flatten(1)))
        x = F.relu(self.fc1(x))
        logits = self.fc2(x)
        return (logits, tap) if taps else logits


def make_model(arch: str, num_classes: int = 1000) -> VGG:
    return VGG(CFGS[arch], num_classes)


def make_bundle(arch: str, state: Optional[dict] = None, seed: int = 0,
                batch_size: int = 50, device=None) -> ModelBundle:
    """The bundle of ``vgg11``..``vgg19``: seeded random weights in flax's
    scheme, or ``state`` (the port's state dict), on ``device``."""
    model = init_flax_default(make_model(arch), seed)
    if state is not None:
        model.load_state_dict(state)
    meta = ModelMeta(name=arch, family="cnn", batch_size=batch_size)
    return ModelBundle(meta, model.to(device))
