"""Batched multi-image attribution: the production ``--image_batch`` path.

Counterpart of ``xai_tpu/methods/batch.py``, CNN family.  The IG family
(ig, lig, idg, idgi, sg) folds the image axis into the chunked
interpolation sweep of ``methods/gradient.py``: one flat sweep over
``B*steps`` (``B*samples*steps`` for sg) images with one target per row,
per-image cutoffs and redistributions as batched tensor logic.  grad and
inp_x_grad are one batched ``score_and_grad``; lime goes through
``lime_batch``.

Outputs are final ``[B, H, W]`` float32 numpy saliencies, post-processed
as the single-image registry entries are, so the driver's battery takes
them directly.  ``dtype=torch.bfloat16`` runs the sweeps on the bundle's
bf16 copy; the Riemann means and the products with the input stay
float32.
"""
from __future__ import annotations

import numpy as np
import torch

from .gradient import (_channel0, _fit_chunk, _idg_sweep, _idgi_sweep,
                       _ig_sweep, sg_noise)

# xai_tpu's batched names (xai_tpu/methods/batch.py BATCH_NAMES)
BATCH_NAMES = {
    "cnn": ("ig", "lig", "idg", "idgi", "sg", "agi", "grad", "inp_x_grad",
            "gbp", "gc", "ggc", "gs", "fa", "occ", "shap", "gig", "lime"),
    "vit": ("attn", "grad", "cam_attn", "n_rollout", "rollout", "t_attn",
            "attn_ig", "attn_attr", "bi_attn", "InFlow", "t_attr",
            "VIT_CX"),
    "clip": ("eclip", "eclip_nograd", "eclip_wo", "maskclip", "grad_cam",
             "selfattn", "game", "rollout", "lrp", "m2ib", "surgery"),
}
PORTED = ("ig", "lig", "idg", "idgi", "sg", "grad", "inp_x_grad", "lime")
# the ROADMAP.md item that ports the rest of each family
NOT_PORTED_ITEM = {"cnn": "A8", "vit": "A10", "clip": "A11"}


def has_batch_impl(family: str, name: str) -> bool:
    return name in BATCH_NAMES.get(family, ())


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


def _grad_batch(bundle, xs, targets, dtype, times_input: bool):
    x = _nchw(xs)
    sweep = bundle.cast(dtype)
    g, _ = sweep.score_and_grad(x.to(sweep.dtype), targets)
    return _saliency(x * g if times_input else g)


def batch_attribution(family, name, bundle, xs, trans_imgs, targets,
                      generators, img_hw=224, steps=50, dtype=None):
    """``[B, H, W]`` float32 numpy saliencies of a batch in a few fused
    sweeps.  xs: ``[B, H, W, C]`` normalized images (moved to the
    bundle's device); trans_imgs: ``[B, H, W, 3]`` in [0, 1] (lime);
    targets: ``[B]`` classes; generators: one ``torch.Generator`` per
    image on the bundle's device (sg, lime).

    Returns None when xai_tpu has no batched implementation either, so
    that the caller loops the per-image path.  A name that xai_tpu batches
    and this package has not ported raises ``NotImplementedError`` naming
    the ROADMAP.md item that ports it."""
    if family in ("vit", "clip") or (has_batch_impl(family, name)
                                     and name not in PORTED):
        raise NotImplementedError(
            f"batched {family} attribution '{name}' is not ported yet "
            f"(ROADMAP.md item {NOT_PORTED_ITEM[family]})")
    if family != "cnn" or name not in PORTED:
        return None
    if name == "lime":
        from .lime import lime_batch
        # registry parity: the model on the unnormalized image, mask * 3
        return 3.0 * lime_batch(bundle, np.asarray(trans_imgs), generators,
                                dtype=dtype, device=bundle.device)
    xs = torch.as_tensor(xs, dtype=torch.float32, device=bundle.device)
    tg = torch.as_tensor(np.asarray(targets), dtype=torch.int64,
                         device=bundle.device)
    if name in ("ig", "lig"):
        sal = ig_lig_batch(bundle, xs, tg, steps,
                           1.0 if name == "ig" else 0.9, dtype)
    elif name in ("idg", "idgi"):
        fn = idg_batch if name == "idg" else idgi_batch
        sal = fn(bundle, xs, tg, steps, dtype,
                 min(bundle.meta.batch_size * 2, 100))
    elif name == "sg":
        sal = sg_batch(bundle, xs, tg, generators, steps, dtype=dtype)
    else:
        sal = _grad_batch(bundle, xs, tg, dtype, name == "inp_x_grad")
    return sal.float().cpu().numpy()
