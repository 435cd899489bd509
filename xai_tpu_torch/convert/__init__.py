"""Checkpoint converters (numpy only) and the ``.npz`` weight carry: the
names of ``xai_tpu.convert``."""
from .torch_import import (
    clip_from_hf,
    clip_from_torch,
    resnet_from_torch,
    vgg_from_torch,
    vit_from_torch,
)

__all__ = ["clip_from_hf", "clip_from_torch", "resnet_from_torch",
           "vgg_from_torch", "vit_from_torch"]
