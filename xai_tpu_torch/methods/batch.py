"""Batched multi-image attribution: the production ``--image_batch`` path.

Counterpart of ``xai_tpu/methods/batch.py``, every family.  The
IG family (ig, lig, idg, idgi, sg) folds the image axis into the chunked
interpolation sweep of ``methods/gradient.py``: one flat sweep over
``B*steps`` (``B*samples*steps`` for sg) images with one target per row,
per-image cutoffs and redistributions as batched tensor logic.  grad,
inp_x_grad, gbp, gc and ggc are one batched backward each; gs, fa, occ
and shap run their cores of ``methods/ablation.py`` over the batch, with
each image's draws taken from its own generator as the per-image path
takes them; gig and agi run their batched loops; lime goes through
``lime_batch``.  rise and xrai have no batched form, in xai_tpu either.
The 11 ViT names run their explainers (``methods/vit_explain.py``,
``methods/vit_lrp.py``) on the batch, every per-image reduction per
image; VIT_CX runs ``vit_cx_batch`` with each image's generator; TIS,
MDA and MDA_dense, which xai_tpu runs image by image, return None.  The
11 batched CLIP names (``CLIP_EXTRA_KIND``) run their explainers
(``methods/clip_explain.py``, ``clip_surgery.py``, ``clip_m2ib.py``) on
the batch with each image's caption rows (``extras``), every reduction
per image; CLIP's rise returns None, as in xai_tpu.

Outputs are final ``[B, H, W]`` float32 numpy saliencies, post-processed
as the single-image registry entries are, so the driver's battery takes
them directly.  ``dtype=torch.bfloat16`` runs the sweeps on the bundle's
bf16 copy (agi: its attacks, after the float32 model's initial
prediction); the Riemann means, the products with the input, the scores
and the maps stay float32.
"""
from __future__ import annotations

import numpy as np
import torch

from . import ablation as AB
from . import clip_explain as CE
from . import vit_explain as VE
from .agi import agi_batch
from .clip_m2ib import vision_heatmap_iba
from .clip_surgery import surgery_map, surgery_text_table
from .gig import guided_ig_batch
from .guided import guided_grads, layer_gradcam
from .gradient import (_channel0, _fit_chunk, _idg_sweep, _idgi_sweep,
                       _ig_sweep, sg_noise)
from .vit_lrp import transformer_attribution
from ..ops.resize import resize_bilinear, resize_nearest_exact

# xai_tpu's batched names (xai_tpu/methods/batch.py BATCH_NAMES)
BATCH_NAMES = {
    "cnn": ("ig", "lig", "idg", "idgi", "sg", "agi", "grad", "inp_x_grad",
            "gbp", "gc", "ggc", "gs", "fa", "occ", "shap", "gig", "lime"),
    "vit": ("attn", "grad", "cam_attn", "n_rollout", "rollout", "t_attn",
            "attn_ig", "attn_attr", "bi_attn", "InFlow", "t_attr",
            "VIT_CX"),
}
# the extra each batched CLIP name takes (xai_tpu's CLIP_EXTRA_KIND): the
# caption embedding (txt), the caption ids (tok) or none
CLIP_EXTRA_KIND = {
    "eclip": "txt", "eclip_nograd": "txt", "eclip_wo": "txt",
    "maskclip": "txt", "grad_cam": "txt", "selfattn": "none",
    "game": "tok", "rollout": "tok", "lrp": "tok", "m2ib": "txt",
    "surgery": "none",
}
BATCH_NAMES["clip"] = tuple(CLIP_EXTRA_KIND)
_EXTRA_KEY = {"txt": "txt_emb", "tok": "text_tokens"}
# production driver constants (evaluatePerturbation.py:94-97, 164-176),
# overridable through batch_attribution(opts=...) for small shapes
_DEFAULT_OPTS = {
    "num_patches": 14,        # fa/shap patch grid, fa/occ down/up grid
    "occ_window": 64, "occ_stride": 32,
    "shap_samples": 25,
    "gc_layer": "layer4",
}


def has_batch_impl(family: str, name: str) -> bool:
    return name in BATCH_NAMES.get(family, ())


# the 11 ViT names of xai_tpu's registry (registry_vit.py, batch.py
# _vit_adapter) -> [B, P, P] patch maps at the drivers' settings
VIT_PATCH_MAPS = {
    "attn": lambda b, x, t: VE.raw_attn(b, x),
    "grad": VE.attn_grad,
    "cam_attn": VE.cam_attn,
    "n_rollout": lambda b, x, t: VE.naive_rollout(b, x),
    "rollout": lambda b, x, t: VE.rollout(b, x),
    "t_attn": VE.transition_attention,
    "attn_ig": VE.attn_ig,
    "attn_attr": VE.attn_attr,
    "bi_attn": VE.bidirectional,
    "InFlow": VE.rave,
    "t_attr": transformer_attribution,
}


def vit_saliency(name, bundle, xs, targets, img_hw) -> torch.Tensor:
    """``[B, H, W]``: the patch maps of ``[B, H, W, C]`` images, upsampled
    bilinearly to the image (xai_tpu's weight matrices, ops/resize.py),
    abs; no x3 (the driver abs-sums one channel).  In the bundle's
    dtype."""
    return resize_bilinear(VIT_PATCH_MAPS[name](bundle, xs, targets),
                           (img_hw, img_hw)).abs()


# the 12 CLIP names of xai_tpu's registry but rise -> [B, P, P] patch maps
# at the drivers' settings; ``ex``: the batch's extras
CLIP_PATCH_MAPS = {
    "eclip": lambda b, x, ex: CE.grad_eclip(b, x, ex["txt_emb"]),
    "eclip_nograd": lambda b, x, ex: CE.grad_eclip(b, x, ex["txt_emb"],
                                                   withgrad=False),
    "eclip_wo": lambda b, x, ex: CE.grad_eclip(b, x, ex["txt_emb"],
                                               withksim=False),
    "maskclip": lambda b, x, ex: CE.mask_clip(b, x, ex["txt_emb"]),
    "grad_cam": lambda b, x, ex: CE.clip_grad_cam(b, x, ex["txt_emb"]),
    "selfattn": lambda b, x, ex: CE.self_attn(b, x),
    "game": lambda b, x, ex: CE.game(b, x, ex["text_tokens"]),
    "rollout": lambda b, x, ex: CE.clip_rollout(b, x),
    "lrp": lambda b, x, ex: CE.clip_lrp(b, x, ex["text_tokens"])[1],
}


def clip_saliency(name, bundle, xs, targets, extras, img_hw,
                  generators=None) -> torch.Tensor:
    """``[B, H, W]`` CLIP saliencies of ``[B, H, W, C]`` images, abs: the
    patch maps upsampled bilinearly; surgery's and m2ib's maps, already
    image-sized, as they are.  ``extras``: ``txt_emb`` ``[B, E]`` and
    ``text_tokens`` ``[B, L]``, a row an image; ``generators``: each
    image's, for m2ib's noise."""
    if name == "surgery":
        return surgery_map(bundle, xs,
                           surgery_text_table(bundle, targets)).abs()
    if name == "m2ib":
        return vision_heatmap_iba(bundle, xs, extras["txt_emb"],
                                  generators=generators).abs()
    return resize_bilinear(CLIP_PATCH_MAPS[name](bundle, xs, extras),
                           (img_hw, img_hw)).abs()


def _nchw(xs: torch.Tensor) -> torch.Tensor:
    return xs.permute(0, 3, 1, 2).contiguous()


def _saliency(attr: torch.Tensor) -> torch.Tensor:
    """``[B, C, H, W]`` -> ``[B, H, W]`` |sum over channels|."""
    return attr.sum(dim=1).abs()


def ig_lig_batch(bundle, xs, targets, steps=50, alpha_star=1.0, dtype=None,
                 chunk=100) -> torch.Tensor:
    """Zero-baseline IG (LIG when alpha_star < 1) of ``[B, H, W, C]``
    images, ``[B, H, W]`` saliencies; one sweep of ``chunk``-image
    forwards and backwards."""
    x = _nchw(xs)
    b = x.shape[0]
    mean = _ig_sweep(bundle.cast(dtype), None, x,
                     targets.repeat_interleave(steps), steps, alpha_star,
                     _fit_chunk(b * steps, chunk))
    return _saliency(mean * x)


def idg_batch(bundle, xs, targets, steps=50, dtype=None, chunk=100
              ) -> torch.Tensor:
    x = _nchw(xs)
    mean = _idg_sweep(bundle.cast(dtype), None, x,
                      targets.repeat_interleave(steps), steps,
                      _fit_chunk(x.shape[0] * steps, chunk))
    return _saliency(mean * x)


def idgi_batch(bundle, xs, targets, steps=50, dtype=None, chunk=100
               ) -> torch.Tensor:
    x = _nchw(xs)
    return _saliency(_idgi_sweep(bundle.cast(dtype), None, x,
                                 targets.repeat_interleave(steps), steps,
                                 _fit_chunk(x.shape[0] * steps, chunk)))


def sg_batch(bundle, xs, targets, generators=None, steps=50, samples=25,
             alpha_star=1.0, dtype=None, chunk=None, quirk=True,
             noises=None) -> torch.Tensor:
    """SmoothGrad-IG of ``[B, H, W, C]`` images: one sweep over
    ``B*samples*steps`` images, each chunk's images built as it runs.
    The noise is ``noises`` (``[B, samples, H, W, C]``, injected), or each
    image's draw from its own generator, as ``smooth_grad`` draws it."""
    if noises is None:
        noises = torch.stack([sg_noise(x, samples, g)
                              for x, g in zip(xs, generators)])
    else:
        noises = torch.as_tensor(noises, dtype=xs.dtype, device=xs.device)
    b, samples = noises.shape[:2]
    xi = _nchw((xs[:, None] + noises).flatten(0, 1))     # [B*S, C, H, W]
    chunk = _fit_chunk(b * samples * steps,
                       chunk or min(bundle.meta.batch_size, steps))
    per_sample = _ig_sweep(bundle.cast(dtype), None, xi,
                           targets.repeat_interleave(samples * steps),
                           steps, alpha_star, chunk) * xi
    if quirk:
        per_sample = _channel0(per_sample)
    return _saliency(per_sample.view((b, samples) + xi.shape[1:])
                     .mean(dim=1))


def _down_up(maps: torch.Tensor, img_hw: int, num_patches: int
             ) -> torch.Tensor:
    """``[B, H, W]``: NEAREST_EXACT to the patch grid, bilinear back."""
    return resize_bilinear(resize_nearest_exact(
        maps, (num_patches, num_patches)), (img_hw, img_hw))


def _generic_batch(name, bundle, xs, tg, generators, img_hw, steps, opts):
    """``[B, H, W]`` saliencies of the methods xai_tpu batches through its
    generic per-image adapters (``_cnn_adapter``): gbp, gc, ggc, gs, fa,
    occ, shap and gig, on ``bundle`` (the sweep's dtype).  A map that the
    per-image entry broadcasts over the 3 channels is abs-summed as 3|m|."""
    x = _nchw(xs)
    n_p = opts["num_patches"]
    if name == "gbp":
        return _saliency(guided_grads(bundle, x, tg))
    if name in ("gc", "ggc"):
        cam = layer_gradcam(bundle, x, tg, opts["gc_layer"])
        if name == "gc":
            return 3.0 * resize_bilinear(cam, (img_hw, img_hw)).abs()
        up = resize_nearest_exact(cam, (img_hw, img_hw))
        return _saliency(guided_grads(bundle, x, tg) * up[:, None])
    if name == "gs":
        return _saliency(AB.gradient_shap_batch(
            bundle, x, tg, [AB.gs_draws(xi, g)
                            for xi, g in zip(xs, generators)]))
    if name == "fa":
        return 3.0 * _down_up(AB.feature_ablation_batch(bundle, x, tg, n_p),
                              img_hw, n_p).abs()
    if name == "occ":
        return 3.0 * _down_up(AB.occlusion_batch(
            bundle, x, tg, opts["occ_window"], opts["occ_stride"]),
            img_hw, n_p).abs()
    if name == "shap":
        perms = torch.stack([AB.shapley_perms(g, n_p ** 2,
                                              opts["shap_samples"])
                             for g in generators])
        return 3.0 * AB.shapley_batch(bundle, x, tg, perms, n_p).abs()
    if name == "gig":
        return _saliency(guided_ig_batch(bundle, x, tg, steps))
    # grad, inp_x_grad
    g, _ = bundle.score_and_grad(x.to(bundle.dtype), tg)
    return _saliency(x * g if name == "inp_x_grad" else g)


def batch_attribution(family, name, bundle, xs, trans_imgs, targets,
                      generators, img_hw=224, steps=50, dtype=None,
                      opts=None, extras=None):
    """``[B, H, W]`` float32 numpy saliencies of a batch in a few fused
    sweeps.  xs: ``[B, H, W, C]`` normalized images (moved to the
    bundle's device); trans_imgs: ``[B, H, W, 3]`` in [0, 1] (lime, agi);
    targets: ``[B]`` classes; generators: one ``torch.Generator`` per
    image on the bundle's device (sg, gs, shap, lime, m2ib).  ``opts``
    overrides the production method constants (``_DEFAULT_OPTS``).
    ``extras`` (CLIP): ``{"txt_emb": [B, E], "text_tokens": [B, L]}``,
    each image's caption embedding and ids (``models/clip.py
    batch_extras``).

    Returns None when xai_tpu has no batched implementation either (rise,
    xrai, TIS, MDA, MDA_dense), so that the caller loops the per-image
    path.  A ViT or CLIP name runs its explainer on the batch, in
    ``dtype`` on the bundle's cast copy (CLIP: with the caption
    embeddings cast too, as xai_tpu casts them)."""
    if not has_batch_impl(family, name):
        return None
    if family == "vit" and name == "VIT_CX":
        from .vit_cx import vit_cx_batch
        # registry parity: 3 * |map| (the driver abs-sums the 3-channel
        # broadcast); each image draws its noise from its own generator
        return 3.0 * np.abs(vit_cx_batch(bundle, xs, targets,
                                         generators=generators, dtype=dtype))
    opts = {**_DEFAULT_OPTS, **(opts or {})}
    if name == "lime":
        from .lime import lime_batch
        # registry parity: the model on the unnormalized image, mask * 3
        return 3.0 * lime_batch(bundle, np.asarray(trans_imgs), generators,
                                dtype=dtype, device=bundle.device)
    if name == "agi":
        return agi_batch(bundle, np.asarray(trans_imgs), dtype=dtype) \
            .abs().cpu().numpy()
    xs = torch.as_tensor(xs, dtype=torch.float32, device=bundle.device)
    tg = torch.as_tensor(np.asarray(targets), dtype=torch.int64,
                         device=bundle.device)
    if family == "vit":
        sal = vit_saliency(name, bundle.cast(dtype), xs, tg, img_hw)
    elif family == "clip":
        key = _EXTRA_KEY.get(CLIP_EXTRA_KIND[name])
        if key is not None and key not in (extras or {}):
            raise ValueError(f"batched CLIP '{name}' needs extras['{key}']")
        ex = {k: torch.as_tensor(v, device=bundle.device)
              for k, v in (extras or {}).items()}
        if dtype is not None and "txt_emb" in ex:
            ex["txt_emb"] = ex["txt_emb"].to(dtype)
        sal = clip_saliency(name, bundle.cast(dtype), xs, tg, ex, img_hw,
                            generators)
    elif name in ("ig", "lig"):
        sal = ig_lig_batch(bundle, xs, tg, steps,
                           1.0 if name == "ig" else 0.9, dtype)
    elif name in ("idg", "idgi"):
        fn = idg_batch if name == "idg" else idgi_batch
        sal = fn(bundle, xs, tg, steps, dtype,
                 min(bundle.meta.batch_size * 2, 100))
    elif name == "sg":
        sal = sg_batch(bundle, xs, tg, generators, steps, dtype=dtype)
    else:
        sal = _generic_batch(name, bundle.cast(dtype), xs, tg, generators,
                             img_hw, steps, opts)
    return sal.float().cpu().numpy()
