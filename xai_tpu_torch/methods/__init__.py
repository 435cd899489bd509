"""The attribution methods.  ``gradient`` is imported here, as in
``xai_tpu.methods``; the registry imports the others when it needs them:
batch (the batched multi-image path), guided, ablation, agi, gig, rise,
lime, xrai, mda, mas_calibrate, mac, vit_explain, vit_lrp, vit_cx, tis,
clip_explain, clip_surgery, clip_m2ib, adversarial, recalibration."""
from . import gradient

__all__ = ["gradient"]
