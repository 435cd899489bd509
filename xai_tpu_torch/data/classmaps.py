"""ImageNet bookkeeping: validation ground truth + per-model
correctly-classified masks (util/class_maps/ImageNet/*).

Counterpart of ``xai_tpu/data/classmaps.py``: plain-text files, one 0/1
(or label int) per line, 1-indexed by validation image number.
``runners/image_finder.py`` writes the masks the drivers filter on.
"""
from __future__ import annotations

import os

import numpy as np


def load_ground_truth(path: str) -> np.ndarray:
    """ILSVRC2012_validation_ground_truth.txt: 50k class labels."""
    with open(path) as f:
        return np.array([int(line.strip()) for line in f], dtype=np.int64)


def load_correct_mask(class_maps_dir: str, model_name: str):
    """correctly_classified_<MODEL>.txt -> 0/1 int array, or None if the
    file hasn't been generated (the runner then accepts every image)."""
    path = os.path.join(class_maps_dir,
                        f"correctly_classified_{model_name}.txt")
    if not os.path.exists(path):
        return None
    return np.loadtxt(path).astype(np.int64)


def save_correct_mask(class_maps_dir: str, model_name: str,
                      mask: np.ndarray) -> str:
    os.makedirs(class_maps_dir, exist_ok=True)
    path = os.path.join(class_maps_dir,
                        f"correctly_classified_{model_name}.txt")
    np.savetxt(path, mask.astype(np.int64), fmt="%d")
    return path
