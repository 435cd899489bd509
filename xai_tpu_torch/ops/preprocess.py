"""Input preprocessing with exact reference parity.

Counterpart of ``xai_tpu/ops/preprocess.py``.  The reference pipeline
(evaluatePerturbation.py:690-694) is Resize(img_hw) with PIL bilinear,
CenterCrop(img_hw), ToTensor, then a per-family Normalize; PIL is used
directly for bit-exact parity.  :func:`load_and_preprocess` is how a
user puts an image file through that pipeline.
"""
from __future__ import annotations

import numpy as np
import torch

try:
    from PIL import Image
except ImportError:  # pragma: no cover
    Image = None

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
VIT_MEAN = (0.5, 0.5, 0.5)
VIT_STD = (0.5, 0.5, 0.5)
CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def center_crop_resize(img, img_hw: int = 224,
                       interpolation=None) -> np.ndarray:
    """PIL image -> [H, W, 3] float32 in [0, 1] (the reference's trans_img,
    transposed to HWC)."""
    if Image is None:
        raise RuntimeError("PIL required for image loading")
    interpolation = interpolation or Image.BILINEAR
    w, h = img.size
    # torchvision F.resize int-size semantics: short side -> img_hw, long
    # side TRUNCATED (int(size * long / short)), not rounded
    if w <= h:
        ow, oh = img_hw, int(img_hw * h / w)
    else:
        ow, oh = int(img_hw * w / h), img_hw
    img = img.resize((ow, oh), interpolation)
    # torchvision CenterCrop: round((dim - crop) / 2)
    left = int(round((ow - img_hw) / 2.0))
    top = int(round((oh - img_hw) / 2.0))
    img = img.crop((left, top, left + img_hw, top + img_hw))
    arr = np.asarray(img, dtype=np.float32) / 255.0
    return arr


def normalize(x: torch.Tensor, mean, std) -> torch.Tensor:
    """Channels-last ([..., C]) normalize."""
    mean = torch.as_tensor(mean, dtype=x.dtype, device=x.device)
    std = torch.as_tensor(std, dtype=x.dtype, device=x.device)
    return (x - mean) / std


def denormalize(x: torch.Tensor, mean, std) -> torch.Tensor:
    """The inverse of :func:`normalize`, channels last."""
    mean = torch.as_tensor(mean, dtype=x.dtype, device=x.device)
    std = torch.as_tensor(std, dtype=x.dtype, device=x.device)
    return x * std + mean


def load_and_preprocess(path: str, img_hw: int = 224, mean=IMAGENET_MEAN,
                        std=IMAGENET_STD, device=None):
    """path -> (trans_img ``[H, W, 3]`` numpy in [0, 1], the normalized
    input ``[1, H, W, 3]`` on ``device``; CUDA unless the caller passes
    ``device="cpu"``).

    Returns None for the images the reference skips
    (evaluatePerturbation.py:539-541 checks shape == (3, hw, hw)): an image
    not in RGB mode is resized and cropped in its own mode, and kept only
    if that gives three channels."""
    from ..runners.common import resolve_device

    device = resolve_device(device)
    with Image.open(path) as img:
        arr = center_crop_resize(img, img_hw)
    if arr.ndim != 3 or arr.shape[-1] != 3:
        return None
    return arr, normalize(torch.as_tensor(arr, device=device), mean, std)[None]
