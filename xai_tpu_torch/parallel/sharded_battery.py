"""The batched metric battery: many images' reveal curves per forward.

Counterpart of ``xai_tpu/parallel/sharded_battery.py`` on one device.
The engine is ``metrics/curves.py`` (``batched_curves``,
``battery_scores``), which the per-image battery runs on a batch of one:
each reveal chunk of a batch is one launch of the reveal kernel
(``kernels/reveal.py reveal_batch``), ``[B, S, C, H, W]``, straight into
one forward of ``B*S`` images.  xai_tpu shards the images over a device
mesh, pads the batch to the mesh and may shard the parameters
(``mesh``, ``param_spec``); the port has no in-process mesh (ROADMAP.md,
"Not queued"), so those are not arguments here.
"""
from __future__ import annotations

import torch

from ..metrics.curves import battery_scores


def sharded_battery_scores(bundle, images: torch.Tensor, saliencies,
                           blur_fn, chunk: int = 45, targets=None):
    """``[B, H, W, C]`` normalized images on the model's device and
    ``[B, H, W]`` saliencies -> one 10-score dict per image.  One blur
    launch over all ``B*C`` planes, the three reveal passes over the
    batch, one device-to-host copy, then ``assemble_battery_scores``.
    ``targets`` are the per-image explanation targets; default argmax
    (evaluatePerturbation.py:561)."""
    return battery_scores(bundle.apply, images, saliencies, blur_fn,
                          chunk=chunk, targets=targets)
