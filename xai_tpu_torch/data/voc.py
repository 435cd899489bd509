"""Pascal VOC segmentation dataset reader
(XAI_Survey/evaluations/data/VOC.py equivalent, minus torchvision deps):
iterates (image, class mask) pairs from a VOCdevkit layout, plus the
results-HDF5 store (expl_hdf5.py) that ``--save_maps`` writes.

Counterpart of ``xai_tpu/data/voc.py``.  ``PIL`` and ``h5py`` are imported
inside the functions that read or write files, so the module imports on a
machine that has neither.
"""
from __future__ import annotations

import os
from typing import Iterator, NamedTuple

import numpy as np

from ..ops.preprocess import center_crop_resize

VOC_CLASSES = (
    "aeroplane", "bicycle", "bird", "boat", "bottle", "bus", "car", "cat",
    "chair", "cow", "diningtable", "dog", "horse", "motorbike", "person",
    "pottedplant", "sheep", "sofa", "train", "tvmonitor")


def require_h5py(what: str) -> None:
    """Raise ``ImportError`` naming h5py and ``what`` if h5py is missing:
    a run that was asked to write HDF5 must not run without writing it."""
    try:
        import h5py  # noqa: F401
    except ImportError as e:
        raise ImportError(f"{what} writes HDF5 and needs h5py, which is "
                          "not installed") from e


class VocItem(NamedTuple):
    name: str
    trans_img: np.ndarray   # [H, W, 3] float in [0, 1]
    gt_mask: np.ndarray     # [H, W] int class ids (255 = void)


class VOCSegmentation:
    def __init__(self, root: str, image_set: str = "val",
                 img_hw: int = 224):
        base = os.path.join(root, "VOCdevkit", "VOC2012")
        lst = os.path.join(base, "ImageSets", "Segmentation",
                           image_set + ".txt")
        with open(lst) as f:
            self.names = [line.strip() for line in f if line.strip()]
        self.img_dir = os.path.join(base, "JPEGImages")
        self.mask_dir = os.path.join(base, "SegmentationClass")
        self.img_hw = img_hw

    def __len__(self):
        return len(self.names)

    def __iter__(self) -> Iterator[VocItem]:
        from PIL import Image

        for name in self.names:
            img = Image.open(os.path.join(self.img_dir, name + ".jpg"))
            arr = center_crop_resize(img.convert("RGB"), self.img_hw)
            mask = Image.open(os.path.join(self.mask_dir, name + ".png"))
            m = center_crop_resize(mask, self.img_hw,
                                   interpolation=Image.NEAREST)
            m = (np.asarray(m) * 255).astype(np.int64) \
                if m.dtype != np.int64 else m
            if m.ndim == 3:
                m = m[..., 0]
            yield VocItem(name, arr, m)


class ExplanationsHDF5:
    """Reader/writer for saved attribution maps (expl_hdf5.py): one dataset
    per image under /maps, metadata in attrs."""

    def __init__(self, path: str, mode: str = "r"):
        import h5py
        self.f = h5py.File(path, mode)
        if "maps" not in self.f and mode != "r":
            self.f.create_group("maps")

    def write(self, name: str, saliency: np.ndarray, **attrs):
        d = self.f["maps"].create_dataset(name, data=saliency)
        for k, v in attrs.items():
            d.attrs[k] = v

    def read(self, name: str) -> np.ndarray:
        return np.asarray(self.f["maps"][name])

    def names(self):
        return list(self.f["maps"].keys())

    def close(self):
        self.f.close()
