"""The batched metric battery: many images' reveal curves per forward,
sharded over a device mesh.

Counterpart of ``xai_tpu/parallel/sharded_battery.py``.  The engine is
``metrics/curves.py`` (``batched_curves``, ``battery_curves``), which the
per-image battery runs on a batch of one: the three reveal passes of a
batch run as one batch of ``3*B`` images, and each reveal chunk is one
launch of the reveal kernel (``kernels/reveal.py reveal_batch``),
``[3*B, S, C, H, W]``, straight into the model: one forward of ``3*B*S``
images while they fit in ``curves.FUSED_ROWS``, else one or two passes'
images a forward.

The images split over the mesh's data rows (``parallel/mesh.py``) in
contiguous, possibly ragged shards, and each row runs one blur launch
over its shard's planes and the three reveal passes on its own device,
its forwards through a ``TensorParallelViT`` over the row's ranks when a
``param_spec`` is given.  Without a mesh the batch is one shard on the
model's device.  xai_tpu pads the batch to the data axis because SPMD
needs equal shards; the port's shards need not be equal, and each
image's scores are the same either way.
"""
from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np
import torch

from ..metrics import curves
from ..utils.trace import span
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
    saliencies = np.asarray(saliencies)
    b, h, w, _ = images.shape
    n_steps = w                         # the battery's step size is h
    with span("battery") as battery:
        desc, asc = curves.flip_schedules(saliencies, h)
        x = images.permute(0, 3, 1, 2).contiguous()
        desc_t = torch.from_numpy(desc.reshape(b, h, w))
        asc_t = torch.from_numpy(asc.reshape(b, h, w))
        if targets is not None:
            targets = torch.as_tensor(targets, dtype=torch.int64)
        # a copy between cards runs on the source card's stream, behind the
        # work queued there, so a copy made after row 0's battery would
        # hold the next row until row 0 had finished
        shards = []
        for r, sl in shard_slices(mesh, b):
            dev = mesh.devices[r][0]
            shards.append((battery, str(dev), forwards[r], blur_fn,
                           x[sl].to(dev), desc_t[sl].to(dev),
                           asc_t[sl].to(dev), n_steps, chunk,
                           None if targets is None else targets[sl].to(dev)))
        if len(shards) == 1:
            out = [_shard_curves(*shards[0])]
        else:
            # one host thread a shard: a card's launch queue holds about a
            # thousand kernels and a shard's battery enqueues thousands, so
            # a single thread would wait on row 0's queue until row 0 had
            # nearly finished before it enqueued row 1 (the cards would
            # take turns)
            with ThreadPoolExecutor(len(shards)) as pool:
                futures = [pool.submit(_shard_curves, *s) for s in shards]
                out = [f.result() for f in futures]
        with span("battery.read"):
            host = np.concatenate([c.cpu().numpy() for c in out], axis=1)
        return curves.assemble_scores(host, saliencies, desc, n_steps)


def _shard_curves(battery, card, *args):
    """One data shard's ``battery_curves``, enqueued (not read) under the
    span ``battery.shard``, a child of the span ``battery``."""
    with span("battery.shard", parent=battery, card=card):
        return curves.battery_curves(*args)
