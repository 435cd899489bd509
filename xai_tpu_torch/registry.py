"""Attribution registry keyed by the reference CLI names.

Counterpart of ``xai_tpu/registry.py``.  Each entry maps a context to a
``[H, W]`` numpy saliency.  This holds the CNN gradient entries ported so
far; the rest of ``xai_tpu``'s table arrives slice by slice (ROADMAP.md).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict

import numpy as np
import torch

from .methods import gradient as G
from .methods.gradient import to_saliency


@dataclasses.dataclass
class AttrContext:
    bundle: Any
    x: torch.Tensor           # normalized [H, W, C] on the model's device
    trans_img: np.ndarray     # [H, W, C] in [0, 1]
    target: int
    img_hw: int = 224
    steps: int = 50


def _abs_sum(fn):
    def wrapped(ctx):
        return to_saliency(fn(ctx))
    return wrapped


# --- CNN family (evaluatePerturbation.py:99-181) ---

CNN_METHODS: Dict[str, Callable] = {
    "grad": _abs_sum(lambda c: G.grad(c.bundle, c.x, c.target)),
    "inp_x_grad": _abs_sum(lambda c: G.inp_x_grad(c.bundle, c.x, c.target)),
    "ig": _abs_sum(lambda c: G.ig(c.bundle, c.x, c.target, c.steps, 1.0,
                                  0.0)),
    "lig": _abs_sum(lambda c: G.ig(c.bundle, c.x, c.target, c.steps, 0.9,
                                   0.0)),
}


def get_attribution(family: str, name: str, ctx: AttrContext) -> np.ndarray:
    methods = {"cnn": CNN_METHODS}[family]
    if name not in methods:
        raise KeyError(
            f"unknown {family} attribution '{name}'; available: "
            f"{sorted(methods)}")
    return np.asarray(methods[name](ctx))
