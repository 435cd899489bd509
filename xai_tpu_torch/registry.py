"""Attribution registry keyed by the reference CLI names.

Counterpart of ``xai_tpu/registry.py``, ``registry_vit.py`` and
``registry_clip.py``.  Each entry maps a context to a ``[H, W]`` numpy
saliency.  This holds every entry of xai_tpu's tables.  As in xai_tpu,
the 11 ViT names of ``methods/batch.py VIT_PATCH_MAPS`` and the 12 CLIP
names (each the batch of one) run in float32 whatever the context's
dtype, while TIS, VIT_CX, MDA and MDA_dense take the context's dtype for
their scoring forwards.  A CLIP entry reads its caption from the
context's ``extras`` (``txt_emb`` ``[1, E]``, ``text_tokens`` ``[1,
L]``; ``models/clip.py clip_extras``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from .methods import ablation as AB
from .methods import gradient as G
from .methods import guided as GD
from .methods.agi import agi
from .methods import vit_explain as VE
from .methods.batch import (CLIP_EXTRA_KIND, VIT_PATCH_MAPS, clip_saliency,
                            vit_saliency)
from .methods.gig import guided_ig
from .methods.gradient import to_saliency
from .methods.lime import lime
from .methods.rise import rise
from .methods.xrai import xrai
from .ops.blur import make_blur_fn
from .ops.resize import resize_bilinear, resize_nearest_exact
from .utils.trace import span


@dataclasses.dataclass
class AttrContext:
    bundle: Any
    x: torch.Tensor           # normalized [H, W, C] on the model's device
    trans_img: np.ndarray     # [H, W, C] in [0, 1]
    target: int
    img_hw: int = 224
    steps: int = 50
    # the counterpart of xai_tpu's per-image PRNG key, on the model's
    # device; the stochastic methods (sg, gs, shap, rise, lime) draw from it
    generator: Optional[torch.Generator] = None
    # the low-precision sweep dtype (driver --attr_dtype), passed to the
    # entries whose methods take dtype= where xai_tpu passes it
    dtype: Any = None
    # CLIP: the target's caption, {"txt_emb": [1, E], "text_tokens": [1, L]}
    extras: Optional[dict] = None


def _abs_sum(fn):
    def wrapped(ctx):
        return to_saliency(fn(ctx))
    return wrapped


def _down_up(attr_hwc: torch.Tensor, img_hw: int,
             num_patches: int = 14) -> torch.Tensor:
    """NEAREST_EXACT downsize to the patch grid + bilinear resize back."""
    down = resize_nearest_exact(attr_hwc.permute(2, 0, 1),
                                (num_patches, num_patches))
    return resize_bilinear(down, (img_hw, img_hw)).permute(1, 2, 0)


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
    "gig": _abs_sum(lambda c: guided_ig(c.bundle, c.x, c.target,
                                        steps=c.steps, fraction=0.5,
                                        max_dist=1.0)),
    "agi": lambda c: np.abs(agi(c.bundle, c.trans_img).cpu().numpy()),
    "sg": _abs_sum(lambda c: G.smooth_grad(c.bundle, c.x, c.target,
                                           _generator(c), "IG", c.steps,
                                           0.0, dtype=c.dtype)),
    "gc": _abs_sum(lambda c: GD.grad_cam(c.bundle, c.x, c.target,
                                         img_hw=c.img_hw)),
    "gbp": _abs_sum(lambda c: GD.guided_backprop(c.bundle, c.x, c.target)),
    "ggc": _abs_sum(lambda c: GD.guided_grad_cam(c.bundle, c.x, c.target,
                                                 img_hw=c.img_hw)),
    "gs": _abs_sum(lambda c: AB.gradient_shap(c.bundle, c.x, c.target,
                                              _generator(c))),
    # fa/occ: the driver post-processes with NEAREST_EXACT downsize to the
    # 14x14 patch grid then bilinear resize back
    # (evaluatePerturbation.py:171-176)
    "fa": _abs_sum(lambda c: _down_up(
        AB.feature_ablation(c.bundle, c.x, c.target), c.img_hw)),
    "occ": _abs_sum(lambda c: _down_up(
        AB.occlusion(c.bundle, c.x, c.target), c.img_hw)),
    "shap": _abs_sum(lambda c: AB.shapley_sampling(c.bundle, c.x, c.target,
                                                   _generator(c))),
    "rise": lambda c: np.abs(rise(c.bundle, c.x, c.target,
                                  _generator(c)).cpu().numpy()),
    # xrai: segments from the normalized input, base attribution = IG
    # (evaluatePerturbation.py:142-146)
    "xrai": lambda c: np.abs(_xrai_entry(c)),
    # lime: the model runs on the UNNORMALIZED [0, 1] image, a reference
    # quirk (limeAttr.py:10-20 never applies the normalize transform); the
    # mask broadcast over 3 channels -> abs-sum = 3 * mask
    "lime": lambda c: 3.0 * _lime_entry(c),
}


def _generator(ctx) -> torch.Generator:
    if ctx.generator is None:
        raise ValueError("this attribution needs AttrContext.generator")
    return ctx.generator


def _xrai_entry(ctx):
    base = G.ig(ctx.bundle, ctx.x, ctx.target, ctx.steps, 1.0, 0.0)
    return xrai(ctx.x.cpu().numpy(), base.cpu().numpy())


def _lime_entry(ctx):
    return lime(ctx.bundle, ctx.trans_img, _generator(ctx),
                device=ctx.x.device, dtype=ctx.dtype)


# --- ViT family (evaluatePerturbation.py:192-266): the patch map upsampled
# bilinearly, abs ---

def _vit_entry(name):
    def entry(c):
        return vit_saliency(name, c.bundle, c.x[None], [c.target],
                            c.img_hw)[0].cpu().numpy()
    return entry


def _default_generator(ctx) -> torch.Generator:
    """The context's generator, else seed 0 on the model's device (xai_tpu
    falls back to ``PRNGKey(0)`` where its context has no key)."""
    if ctx.generator is not None:
        return ctx.generator
    return torch.Generator(ctx.x.device).manual_seed(0)


def _tis_entry(ctx):
    from .methods.tis import tis
    sal = tis(ctx.bundle, ctx.x, ctx.target,
              generator=_default_generator(ctx), dtype=ctx.dtype)
    return resize_bilinear(sal, (ctx.img_hw, ctx.img_hw)).abs().cpu().numpy()


def _vit_cx_entry(ctx):
    from .methods.vit_cx import vit_cx
    # the driver broadcasts over 3 channels then abs-sums -> 3 * map
    return 3.0 * np.abs(vit_cx(ctx.bundle, ctx.x, ctx.target,
                               generator=_default_generator(ctx),
                               dtype=ctx.dtype))


def adaptive_blur(bundle, x: torch.Tensor, target: int):
    """(blur_fn, klen) of MDA's adaptive blur (evaluatePerturbation.py:
    243-257): grow klen from 31 by 4 until the blurred image's softmax at
    the target is <= 1 % or klen > 101 (so at most 103)."""
    xb = x.permute(2, 0, 1)[None].contiguous()
    klen = 31
    while True:
        blur_fn = make_blur_fn(klen, float(klen))
        with torch.no_grad():
            probs = torch.softmax(bundle.apply(blur_fn(xb))[0], -1)
        if float(probs[target]) * 100 <= 1 or klen > 101:
            return blur_fn, klen
        klen += 4


def _mda_entry(ctx, dense: bool = False):
    from .methods.mda import mda, mda_dense

    blur_fn, _ = adaptive_blur(ctx.bundle, ctx.x, ctx.target)
    prior = VE.bidirectional(ctx.bundle, ctx.x[None], [ctx.target])[0]
    prior_up = resize_bilinear(prior, (ctx.img_hw, ctx.img_hw)).cpu().numpy()
    prior3 = np.repeat(prior_up[..., None], 3, axis=-1)
    patch_count = ctx.bundle.meta.num_patches ** 2
    if dense:
        # the seg driver's variant (evaluateImageNetSeg.py:291-326): the
        # dense rank map, no 3x abs-sum (it is consumed minmax-normalized)
        return mda_dense(ctx.bundle, ctx.trans_img, ctx.x, prior3,
                         patch_count, blur_fn, target=ctx.target,
                         dtype=ctx.dtype)
    m = mda(ctx.bundle, ctx.trans_img, ctx.x, prior3, patch_count, blur_fn,
            target=ctx.target, dtype=ctx.dtype)
    return 3.0 * np.abs(m)


VIT_METHODS: Dict[str, Callable] = {n: _vit_entry(n) for n in VIT_PATCH_MAPS}
VIT_METHODS.update({
    "TIS": _tis_entry,
    "VIT_CX": _vit_cx_entry,
    "MDA": _mda_entry,
    "MDA_dense": lambda c: _mda_entry(c, dense=True),
})


# --- CLIP family (evaluatePerturbation.py:373-445): the patch map
# upsampled bilinearly, abs; surgery and m2ib image-sized, abs ---

def _clip_entry(name):
    def entry(c):
        if c.extras is None:
            raise ValueError(f"CLIP '{name}' needs AttrContext.extras")
        gens = [_default_generator(c)] if name == "m2ib" else None
        return clip_saliency(name, c.bundle, c.x[None], [c.target],
                             c.extras, c.img_hw, gens)[0].cpu().numpy()
    return entry


CLIP_METHODS: Dict[str, Callable] = {n: _clip_entry(n)
                                     for n in CLIP_EXTRA_KIND}
CLIP_METHODS["rise"] = CNN_METHODS["rise"]
FAMILY_METHODS = {"cnn": CNN_METHODS, "vit": VIT_METHODS,
                  "clip": CLIP_METHODS}


def get_attribution(family: str, name: str, ctx: AttrContext) -> np.ndarray:
    methods = FAMILY_METHODS[family]
    if name not in methods:
        raise KeyError(
            f"unknown {family} attribution '{name}'; available: "
            f"{sorted(methods)}")
    with span("attribution"):
        return np.asarray(methods[name](ctx))
