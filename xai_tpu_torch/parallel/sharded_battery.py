"""The batched metric battery sharded over a device mesh.

Counterpart of ``xai_tpu/parallel/sharded_battery.py``.  The battery is
``metrics/curves.py``'s; the mesh (``parallel/mesh.py``) only says which
images go to which card, with which forward.  The images split over the
mesh's data rows in contiguous, possibly ragged shards, and each row runs
one blur launch over its shard's planes and the three reveal passes on
its own device, its forwards through a ``TensorParallelViT`` over the
row's ranks when a ``param_spec`` is given.  Without a mesh the batch is
one shard on the model's device.  xai_tpu pads the batch to the data axis
because SPMD needs equal shards; the port's shards need not be equal, and
each image's scores are the same either way.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..metrics import curves
from .mesh import Mesh, make_mesh, row_forwards, shard_slices


def sharded_battery_scores(bundle, images: torch.Tensor, saliencies,
                           blur_fn, chunk: int = 45, targets=None,
                           mesh: Optional[Mesh] = None,
                           param_spec: Optional[dict] = None) -> list:
    """``[B, H, W, C]`` normalized images and ``[B, H, W]`` saliencies ->
    one 10-score dict per image.  ``targets`` are the per-image
    explanation targets; default argmax (evaluatePerturbation.py:561).

    One blur launch and the three reveal passes a non-empty data shard of
    ``mesh`` (default: the whole batch on the bundle's device).  The host
    computes every image's flip steps first; every shard's inputs reach
    its card before any shard's work is enqueued; then one device-to-host
    copy a shard and the scores in image order.  A bundle keeps its
    replicas on other cards (``ModelBundle.to``), so a driver's flushes
    copy its weights to a card once a run."""
    if mesh is None:
        mesh = make_mesh(devices=[bundle.device])
    forwards = row_forwards(mesh, bundle, param_spec)
    shards = [(forwards[r], mesh.devices[r][0], sl)
              for r, sl in shard_slices(mesh, images.shape[0])]
    return curves._battery_over_shards(images, saliencies, blur_fn, chunk,
                                       targets, shards)
