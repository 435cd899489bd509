"""ImageNet-val streaming matching the reference driver's iteration order
(evaluatePerturbation.py:520-560): sorted listdir, file-name-derived 0-based
index, PIL Resize/CenterCrop/ToTensor, RGB-only filter.

Counterpart of ``xai_tpu/data/imagenet.py``, including its deterministic
synthetic stream (``np.random.RandomState``), so both packages see the
same images from the same seed.
"""
from __future__ import annotations

import os
from typing import Iterator, NamedTuple

import numpy as np

from ..ops.preprocess import center_crop_resize

try:
    from PIL import Image
except ImportError:  # pragma: no cover
    Image = None


class ValImage(NamedTuple):
    index: int            # 0-based validation index
    name: str
    trans_img: np.ndarray  # [H, W, 3] float32 in [0, 1]


def parse_val_index(filename: str) -> int:
    """'ILSVRC2012_val_00000001.JPEG' -> 0 (reference:528)."""
    return int(filename.split("_")[2].split(".")[0]) - 1


class ImageNetValStream:
    def __init__(self, dataset_path: str, img_hw: int = 224,
                 synthetic: int = 0, seed: int = 0):
        self.dataset_path = dataset_path
        self.img_hw = img_hw
        self.synthetic = synthetic
        self.seed = seed

    def __iter__(self) -> Iterator[ValImage]:
        if self.synthetic:
            rs = np.random.RandomState(self.seed)
            for i in range(self.synthetic):
                img = rs.rand(self.img_hw, self.img_hw, 3).astype(np.float32)
                yield ValImage(i, f"synthetic_val_{i + 1:08d}.JPEG", img)
            return
        for name in sorted(os.listdir(self.dataset_path)):
            try:
                idx = parse_val_index(name)
            except (IndexError, ValueError):
                continue
            img = Image.open(os.path.join(self.dataset_path, name))
            arr = center_crop_resize(img, self.img_hw)
            if arr.ndim != 3 or arr.shape[-1] != 3:
                continue  # reference skips non-RGB (:539-541)
            yield ValImage(idx, name, arr)
