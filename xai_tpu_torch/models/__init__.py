"""The port's model families and the image finder's extended zoo.

``EXTENDED_ZOO`` maps each of xai_tpu's 23 zoo names (the reference's
image finder choices) to its family module and arch, as
``xai_tpu/models/__init__.py`` has them; :func:`get_bundle` builds one.
The families are imported when a bundle is built, not with this package.
"""
from __future__ import annotations

import importlib
from typing import Optional

EXTENDED_ZOO = {
    "R50": ("resnet", "R50"), "R101": ("resnet", "R101"),
    "R152": ("resnet", "R152"), "RNXT": ("resnet", "RNXT"),
    "VGG19": ("vgg", "vgg19"), "VGG16": ("vgg", "vgg16"),
    "VIT8": ("vit", "VIT8"), "VIT16": ("vit", "VIT16"),
    "VIT32": ("vit", "VIT32"),
    "VIT_tiny": ("vit", "vit_tiny_patch16_224"),
    "VIT_base": ("vit", "vit_base_patch16_224"),
    "VIT_large": ("vit", "vit_large_patch16_224"),
    # xai_tpu's mapping, kept as it is: the reference's CONVNXT is
    # torchvision's convnext_large (ROADMAP.md section C)
    "CONVNXT": ("convnext", "convnext_base"),
    "MAXVIT": ("maxvit", None),
    "IV3": ("inception", None),
    "swin_tiny": ("swin", "swin_tiny"), "swin_small": ("swin", "swin_small"),
    "swin_base": ("swin", "swin_base"),
    "pvt_tiny": ("pvt", "pvt_tiny"), "pvt_small": ("pvt", "pvt_small"),
    "pvt_med": ("pvt", "pvt_medium"),
    "CLIP16": ("clip", "CLIP16"), "CLIP32": ("clip", "CLIP32"),
}


def get_bundle(name: str, state: Optional[dict] = None, seed: int = 0,
               device=None):
    """The bundle of any zoo name: seeded random weights in flax's scheme,
    or ``state`` (the port's state dict, e.g. from
    ``convert/from_jax.py load_params``), on ``device``."""
    module_name, arch = EXTENDED_ZOO[name]
    mod = importlib.import_module(f".{module_name}", __package__)
    if arch is None:
        return mod.make_bundle(state=state, seed=seed, device=device)
    return mod.make_bundle(arch, state=state, seed=seed, device=device)
