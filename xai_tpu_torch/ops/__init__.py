"""Preprocessing, the blur substrate, resizes and curve statistics: the
names of ``xai_tpu.ops``."""
from .blur import gaussian_blur, gkern, make_blur_fn
from .preprocess import center_crop_resize, load_and_preprocess, normalize
from .resize import resize_bilinear, resize_nearest_exact
from .stats import auc, entropy_bits, spearman

__all__ = [
    "gkern", "make_blur_fn", "gaussian_blur",
    "resize_bilinear", "resize_nearest_exact",
    "load_and_preprocess", "normalize", "center_crop_resize",
    "auc", "spearman", "entropy_bits",
]
