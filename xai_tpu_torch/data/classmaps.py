"""Per-model correctly-classified masks (util/class_maps/ImageNet/*).

Counterpart of ``xai_tpu/data/classmaps.py``: plain-text files, one 0/1
per line, 1-indexed by validation image number.
"""
from __future__ import annotations

import os

import numpy as np


def load_correct_mask(class_maps_dir: str, model_name: str):
    """correctly_classified_<MODEL>.txt -> 0/1 int array, or None if the
    file hasn't been generated (the runner then accepts every image)."""
    path = os.path.join(class_maps_dir,
                        f"correctly_classified_{model_name}.txt")
    if not os.path.exists(path):
        return None
    return np.loadtxt(path).astype(np.int64)
