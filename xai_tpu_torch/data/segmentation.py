"""ImageNet-Segmentation dataset reader (gtsegs_ijcv.mat, h5 layout) —
XAI_Survey/evaluations/data/Imagenet.py:42-83 — plus a synthetic stream for
dataset-free runs.

Counterpart of ``xai_tpu/data/segmentation.py``.  The synthetic stream
draws from ``np.random.RandomState(seed)`` in xai_tpu's order, so both
packages see the same images and masks.  ``h5py`` and ``PIL`` are
imported only where the real file is read.
"""
from __future__ import annotations

from typing import Iterator, NamedTuple

import numpy as np

from ..ops.preprocess import center_crop_resize


class SegItem(NamedTuple):
    trans_img: np.ndarray    # [H, W, 3] float in [0, 1]
    gt_mask: np.ndarray      # [H, W] int {0, 1}


class ImagenetSegmentation:
    """Iterates (image, binary gt mask), both center-crop-resized to
    img_hw (the reference's transform + NEAREST target transform)."""

    def __init__(self, path: str, img_hw: int = 224, synthetic: int = 0,
                 seed: int = 0):
        self.path = path
        self.img_hw = img_hw
        self.synthetic = synthetic
        self.seed = seed
        if not synthetic:
            import h5py
            with h5py.File(path, "r") as f:
                self.length = len(f["/value/img"])
        else:
            self.length = synthetic

    def __len__(self):
        return self.length

    def __iter__(self) -> Iterator[SegItem]:
        if self.synthetic:
            rs = np.random.RandomState(self.seed)
            for _ in range(self.synthetic):
                img = rs.rand(self.img_hw, self.img_hw, 3).astype(np.float32)
                m = np.zeros((self.img_hw, self.img_hw), np.int64)
                r = rs.randint(4, self.img_hw // 2)
                cy, cx = rs.randint(r, self.img_hw - r, 2)
                yy, xx = np.ogrid[:self.img_hw, :self.img_hw]
                m[(yy - cy) ** 2 + (xx - cx) ** 2 < r * r] = 1
                yield SegItem(img, m)
            return
        import h5py
        from PIL import Image

        with h5py.File(self.path, "r") as f:
            for i in range(self.length):
                img = np.array(f[f["/value/img"][i, 0]]).transpose(2, 1, 0)
                tgt = np.array(
                    f[f[f["/value/gt"][i, 0]][0, 0]]).transpose(1, 0)
                pil = Image.fromarray(img).convert("RGB")
                arr = center_crop_resize(pil, self.img_hw)
                tgt_img = Image.fromarray(tgt.astype(np.uint8))
                tgt_arr = center_crop_resize(tgt_img, self.img_hw,
                                             interpolation=Image.NEAREST)
                mask = (np.asarray(tgt_arr) > 0).astype(np.int64)
                if mask.ndim == 3:
                    mask = mask[..., 0]
                yield SegItem(arr, mask)
