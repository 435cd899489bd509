"""Shared runner plumbing: model construction by CLI name, device choice,
per-image gates and generators, the registry context and the batched
attribution of kept images, result CSV writing.

Counterpart of ``xai_tpu/runners/common.py``.  Entry points run on CUDA
unless the caller passes ``device="cpu"``; with no device and no CUDA they
raise rather than carry on on the CPU.
"""
from __future__ import annotations

import csv
import os
import time
from typing import Optional

import numpy as np
import torch

from ..convert.from_jax import load_params
from ..methods.batch import batch_attribution
from ..models import clip, resnet, vit
from ..models.clip import batch_extras, clip_extras
from ..models.common import ModelBundle, ModelMeta
from ..ops.blur import make_blur_fn
from ..ops.preprocess import (CLIP_MEAN, CLIP_STD, IMAGENET_MEAN,
                              IMAGENET_STD, VIT_MEAN, VIT_STD, normalize)
from ..registry import AttrContext, get_attribution
from ..utils.trace import span

ATTR_DTYPES = {"f32": None, "bf16": torch.bfloat16}

# reference per-model batch sizes (evaluatePerturbation.py:627-677), as
# xai_tpu's table has them
MODEL_TABLE = {
    "R50": ("cnn", 50), "R101": ("cnn", 50), "R152": ("cnn", 50),
    "RNXT": ("cnn", 25),
    "VIT16": ("vit", 25), "VIT32": ("vit", 50),
    "CLIP16": ("clip", 25), "CLIP32": ("clip", 50),
    # 1-block-per-stage ResNets for fast CPU runs of the full driver path:
    # TINY_CNN at 224 px, TINY_R at 64 px (the driver-parity model); and
    # timm's vit_tiny_patch16_224 (192 wide, 3 heads)
    "TINY_CNN": ("cnn", 50), "TINY_R": ("cnn", 50), "TINY_VIT": ("vit", 25),
}

# each family's input normalization (xai_tpu's family_stats)
FAMILY_STATS = {"cnn": (IMAGENET_MEAN, IMAGENET_STD),
                "vit": (VIT_MEAN, VIT_STD),
                "clip": (CLIP_MEAN, CLIP_STD)}


def model_entry(model_name: str):
    """(family, batch size) of a CLI model name."""
    return MODEL_TABLE[model_name]


def resolve_device(device=None) -> torch.device:
    """``None`` means CUDA.  Raises when CUDA is asked for and absent."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device available; pass "
                               "device='cpu' to run on the CPU")
        # f32 means f32: by default cuDNN runs float32 convolutions in
        # TF32 (~3 decimal digits), which would break parity with xai_tpu
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    return device


def build_bundle(model_name: str, params_path: Optional[str] = None,
                 seed: int = 0, device=None) -> ModelBundle:
    """The bundle for a reference CLI model name.  Weights come from an
    ``xai_tpu``-saved ``.npz`` if given, else a seeded random init.  A
    CLIP bundle gets the class-prompt text table of its own text tower,
    built after the weights are in (xai_tpu's ``build_bundle``)."""
    device = resolve_device(device)
    family, batch = model_entry(model_name)
    state = load_params(params_path) if params_path else None
    if family == "clip":
        return clip.make_bundle(model_name, state, seed, batch, device)
    if family == "vit":
        arch = "vit_tiny_patch16_224" if model_name == "TINY_VIT" \
            else model_name
        return vit.make_bundle(arch, state, seed, batch, device)
    if model_name not in ("TINY_CNN", "TINY_R"):
        return resnet.make_bundle(model_name, state, seed, batch, device)
    module = resnet.init_random(resnet.ResNet(layers=(1, 1, 1, 1)), seed)
    meta = (ModelMeta(name="TINY_R", family="cnn", img_hw=64,
                      batch_size=batch) if model_name == "TINY_R" else
            ModelMeta(name="resnet50", family="cnn", batch_size=batch))
    if state is not None:
        module.load_state_dict(state)
    return ModelBundle(meta, module.to(device))


def family_stats(family: str):
    """(mean, std) of a family's input normalization."""
    return FAMILY_STATS[family]


def normalize_input(trans_img: np.ndarray, family: str,
                    device) -> torch.Tensor:
    """[H, W, C] in [0, 1] -> normalized [H, W, C] on ``device``."""
    with span("normalize_input"):
        return normalize(torch.as_tensor(trans_img, device=device),
                         *family_stats(family))


def image_gates(bundle, x: torch.Tensor, blur_fn, gates: bool = True):
    """The reference's per-image sanity gates
    (evaluatePerturbation.py:561-570): predictions for the original, blurred
    and black images; the image is usable iff blur/black confidences are
    lower and classes differ.  ``gates=False`` (--skip_gates / synthetic
    runs) returns after the first forward.  x: [H, W, C]."""
    with span("image_gates"):
        xb = x.permute(2, 0, 1)[None].contiguous()
        probs = bundle.probs(xb)[0].cpu().numpy()
        target = int(probs.argmax())
        original_pred = float(probs[target])
        if not gates:
            return target, original_pred, True
        bl = bundle.probs(blur_fn(xb))[0].cpu().numpy()
        blur_class = int(bl.argmax())
        blur_own = float(bl[blur_class])
        bk = bundle.probs(torch.zeros_like(xb))[0].cpu().numpy()
        black_class = int(bk.argmax())
        black_own = float(bk[black_class])
        ok = not (blur_own >= original_pred or black_own >= original_pred
                  or target == black_class or target == blur_class)
        return target, original_pred, ok


def image_generator(seed: int, index: int, device) -> torch.Generator:
    """The generator of image ``index``, deterministic in ``(seed,
    index)``: the counterpart of xai_tpu's ``fold_in(PRNGKey(seed),
    index)``.  A caller that attributes one image twice (the sanity
    driver's two weight sets) builds one for each, so both draw alike."""
    state = np.random.SeedSequence([seed, index]).generate_state(
        1, np.uint64)[0]
    return torch.Generator(device).manual_seed(int(state))


def attr_context(bundle, p, dtype=None) -> AttrContext:
    """The registry context of one kept image ``p`` (a dict with ``x``,
    ``trans_img``, ``target`` and ``generator``); a CLIP image's also
    holds its target's caption (``clip_extras``, from ``bundle``'s own
    text table)."""
    return AttrContext(bundle=bundle, x=p["x"], trans_img=p["trans_img"],
                       target=p["target"], img_hw=bundle.meta.img_hw,
                       generator=p["generator"], dtype=dtype,
                       extras=(clip_extras(bundle, p["target"])
                               if bundle.meta.family == "clip" else None))


def batch_attribute(bundle, family, attr_func, pend, dtype=None):
    """Attribute a pending batch with the batched implementation
    (``methods/batch.py``), or image by image through the registry where
    there is none (rise, xrai).  Returns ([B, H, W] saliencies,
    seconds)."""
    t = time.time()
    targets = [p["target"] for p in pend]
    with span("attribution"):
        sals = batch_attribution(
            family, attr_func, bundle, torch.stack([p["x"] for p in pend]),
            np.stack([p["trans_img"] for p in pend]), targets,
            [p["generator"] for p in pend], img_hw=bundle.meta.img_hw,
            dtype=dtype, extras=(batch_extras(bundle, targets)
                                 if family == "clip" else None))
        if sals is None:
            sals = np.stack([get_attribution(family, attr_func,
                                             attr_context(bundle, p, dtype))
                             for p in pend])
    # returns host numpy, so the device work is done
    return sals, time.time() - t


@torch.no_grad()
def predict_classes(bundle, xs: torch.Tensor) -> list:
    """Top-1 classes of ``[B, H, W, C]`` normalized images, one forward."""
    return bundle.apply(xs.permute(0, 3, 1, 2).contiguous()).argmax(
        -1).tolist()


def write_result_csv(folder: str, file_name: str, counters: dict,
                     images_used: int, attr_time: float, total_time: float):
    """Identical CSV layout to the reference (evaluatePerturbation.py:606-618)."""
    os.makedirs(folder, exist_ok=True)
    with open(os.path.join(folder, file_name + ".csv"), "w") as f:
        w = csv.writer(f)
        for k in counters:
            w.writerow([k, str(counters[k] / images_used)])
        w.writerow(["Attr Avg Runtime", str(attr_time / images_used)])
        w.writerow(["Total Runtime", str(total_time)])


def default_blur():
    return make_blur_fn(31, 31.0)
