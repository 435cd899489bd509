"""The perturbation battery and its curve pieces: the names of
``xai_tpu.metrics``.  ``run_battery(apply_fn, x, saliency, blur_fn)`` takes
no ``params``: the bundle's module holds them."""
from .curves import (
    CurveOutputs,
    mas_scores,
    monotone_normalize,
    patch_flip_steps,
    pixel_flip_steps,
    reveal_curves,
    run_battery,
)

__all__ = [
    "CurveOutputs", "pixel_flip_steps", "patch_flip_steps", "reveal_curves",
    "monotone_normalize", "mas_scores", "run_battery",
]
