"""ImageNet-val bookkeeping and class maps: the names of
``xai_tpu.data``."""
from .classmaps import load_correct_mask, load_ground_truth
from .imagenet import ImageNetValStream, parse_val_index

__all__ = ["ImageNetValStream", "parse_val_index", "load_correct_mask",
           "load_ground_truth"]
