"""Attribution registry keyed by the reference CLI names.

Counterpart of ``xai_tpu/registry.py``.  Each entry maps a context to a
``[H, W]`` numpy saliency.  This holds the CNN entries ported so far
(the gradient family, IDG, IDGI, SmoothGrad and LIME); the rest of
``xai_tpu``'s table arrives slice by slice (ROADMAP.md).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from .methods import gradient as G
from .methods.gradient import to_saliency
from .methods.lime import lime


@dataclasses.dataclass
class AttrContext:
    bundle: Any
    x: torch.Tensor           # normalized [H, W, C] on the model's device
    trans_img: np.ndarray     # [H, W, C] in [0, 1]
    target: int
    img_hw: int = 224
    steps: int = 50
    # the counterpart of xai_tpu's per-image PRNG key, on the model's
    # device; the stochastic methods (sg, lime) draw from it
    generator: Optional[torch.Generator] = None
    # the low-precision sweep dtype (driver --attr_dtype), passed to the
    # entries whose methods take dtype= where xai_tpu passes it
    dtype: Any = None


def _abs_sum(fn):
    def wrapped(ctx):
        return to_saliency(fn(ctx))
    return wrapped


# --- CNN family (evaluatePerturbation.py:99-181) ---

CNN_METHODS: Dict[str, Callable] = {
    "grad": _abs_sum(lambda c: G.grad(c.bundle, c.x, c.target)),
    "inp_x_grad": _abs_sum(lambda c: G.inp_x_grad(c.bundle, c.x, c.target)),
    "ig": _abs_sum(lambda c: G.ig(c.bundle, c.x, c.target, c.steps, 1.0,
                                  0.0, dtype=c.dtype)),
    "lig": _abs_sum(lambda c: G.ig(c.bundle, c.x, c.target, c.steps, 0.9,
                                   0.0, dtype=c.dtype)),
    "idg": _abs_sum(lambda c: G.idg(c.bundle, c.x, c.target, c.steps, 0.0)),
    "idgi": _abs_sum(lambda c: G.idgi(c.bundle, c.x, c.target, c.steps,
                                      0.0)),
    "sg": _abs_sum(lambda c: G.smooth_grad(c.bundle, c.x, c.target,
                                           _generator(c), "IG", c.steps,
                                           0.0, dtype=c.dtype)),
    # lime: the model runs on the UNNORMALIZED [0, 1] image, a reference
    # quirk (limeAttr.py:10-20 never applies the normalize transform); the
    # mask broadcast over 3 channels -> abs-sum = 3 * mask
    "lime": lambda c: 3.0 * _lime_entry(c),
}


def _generator(ctx) -> torch.Generator:
    if ctx.generator is None:
        raise ValueError("this attribution needs AttrContext.generator")
    return ctx.generator


def _lime_entry(ctx):
    return lime(ctx.bundle, ctx.trans_img, _generator(ctx),
                device=ctx.x.device, dtype=ctx.dtype)


def get_attribution(family: str, name: str, ctx: AttrContext) -> np.ndarray:
    methods = {"cnn": CNN_METHODS}[family]
    if name not in methods:
        raise KeyError(
            f"unknown {family} attribution '{name}'; available: "
            f"{sorted(methods)}")
    return np.asarray(methods[name](ctx))
