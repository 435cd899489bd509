"""Sharded evaluation and the MAS-calibration train step over a device mesh.

Counterpart of ``xai_tpu/parallel/sharded_eval.py``.  Images split over
the mesh's ``data`` rows (``mesh.shard_batch``), each row runs its shard
on its own device, a ViT optionally split over the row's ``model`` ranks
(``param_spec``, ``mesh.TensorParallelViT``), and the per-image results
gather to the mesh's first device for the means.

:func:`make_sharded_train_step` is the package's training-shaped
workload, the MAS calibration (MASCalibrate.py:1315-1419): IG of each
image, an affine calibration ``attr * scale + bias``, soft insertion /
deletion curves from sigmoid masks at saliency quantiles, the mean loss,
one backward across the devices, and an Adam update of ``scale`` and
``bias`` (optax's, written out: ``methods/mas_calibrate.py Adam``).
xai_tpu vmaps a per-image function, so each image's min-max is its own;
the port reduces per image too.  The subgradients are JAX's: ``|x|`` has
slope +1 at 0 (``jax_abs``), and min and max split the gradient evenly
over ties (``amin`` / ``amax``).

Images are NCHW, as the port's models take them.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..methods.mas_calibrate import Adam, jax_abs
from .mesh import Mesh, row_forwards, shard_batch


def _ig_attr(forward, x: torch.Tensor, targets: torch.Tensor,
             steps: int) -> torch.Tensor:
    """IG of each image of ``x`` ``[B, C, H, W]`` at its target, the
    alphas of every image in one batch: the mean gradient at
    ``linspace(0, 1, steps) * x``, times ``x``."""
    b = x.shape[0]
    alphas = torch.linspace(0.0, 1.0, steps, device=x.device,
                            dtype=x.dtype).view(1, steps, 1, 1, 1)
    imgs = (alphas * x[:, None]).flatten(0, 1).detach().requires_grad_(True)
    with torch.enable_grad():
        logits = forward(imgs)
        score = logits.gather(
            1, targets.repeat_interleave(steps)[:, None]).sum()
        (grads,) = torch.autograd.grad(score, imgs)
    return grads.view(b, steps, *x.shape[1:]).mean(1) * x


def _soft_curves(forward, x: torch.Tensor, attr: torch.Tensor,
                 targets: torch.Tensor, n_thresh: int, tau: float = 10.0):
    """The differentiable insertion / deletion proxy: each image's
    ``|attr.sum(channel)|`` min-maxed, masks ``sigmoid(tau * (sal - q))``
    at ``n_thresh`` quantiles ``q`` in [0.05, 0.95], and the target's
    softmax probability on ``x * m`` and ``x * (1 - m)``.  Returns (ins,
    del), each ``[B, n_thresh]``."""
    b, n = x.shape[0], n_thresh
    sal = jax_abs(attr.sum(1))
    lo = sal.amin(dim=(1, 2), keepdim=True)
    hi = sal.amax(dim=(1, 2), keepdim=True)
    sal = (sal - lo) / (hi - lo + 1e-8)
    qs = torch.linspace(0.05, 0.95, n, device=x.device, dtype=x.dtype)
    m = torch.sigmoid(tau * (sal[:, None] - qs.view(1, n, 1, 1)))[:, :, None]
    xs = x[:, None]
    probes = torch.cat([(xs * m).flatten(0, 1), (xs * (1 - m)).flatten(0, 1)])
    probs = torch.softmax(forward(probes), -1)
    tgt = targets.repeat_interleave(n).repeat(2)[:, None]
    ins, dele = probs.gather(1, tgt).view(2, b, n)
    return ins, dele


def sharded_eval_step(model, mesh: Mesh, param_spec: Optional[dict] = None):
    """``step(images, targets) -> {"mean_target_prob", "accuracy"}``: the
    mean softmax probability of each image's target and the top-1 hit
    rate over the batch, 0-d tensors on the mesh's first device.
    ``model``: an ``nn.Module`` mapping NCHW to logits (with
    ``param_spec``, a ``VisionTransformer``)."""
    forwards = row_forwards(mesh, model, param_spec)
    first = mesh.devices[0][0]

    @torch.no_grad()
    def step(images: torch.Tensor, targets: torch.Tensor) -> dict:
        targets = torch.as_tensor(targets, dtype=torch.int64)
        # every shard's inputs are copied, and its work enqueued, before
        # any result is gathered (a copy between cards runs behind the
        # source card's queue)
        tp, hit = [], []
        for (r, x), (_, t) in zip(shard_batch(mesh, images),
                                  shard_batch(mesh, targets)):
            logits = forwards[r](x)
            probs = torch.softmax(logits, -1)
            tp.append(probs.gather(1, t[:, None])[:, 0])
            hit.append((logits.argmax(-1) == t).to(probs.dtype))
        return {"mean_target_prob": torch.cat([v.to(first) for v in tp])
                .mean(),
                "accuracy": torch.cat([v.to(first) for v in hit]).mean()}

    return step


def make_sharded_train_step(model, mesh: Mesh,
                            param_spec: Optional[dict] = None,
                            ig_steps: int = 4, n_thresh: int = 4,
                            lr: float = 1e-2):
    """The sharded MAS-calibration step: ``(step, init_fn)``.
    ``init_fn() -> (calib, opt_state)``, calib ``{"scale": 1, "bias": 0}``
    on the mesh's first device; ``step(calib, opt_state, images, targets)
    -> (calib, opt_state, loss)``; calib in the model's dtype, as
    xai_tpu's follows its float width.  Each image's loss is ``(1 -
    mean(ins)) + mean(del)``; the losses gather to the first device, and
    their mean's one backward reaches every shard.  ``opt_state`` is
    updated in place, as xai_tpu donates it."""
    forwards = row_forwards(mesh, model, param_spec)
    first = mesh.devices[0][0]

    dtype = next(model.parameters()).dtype

    def init_fn():
        calib = {"scale": torch.ones((), dtype=dtype, device=first),
                 "bias": torch.zeros((), dtype=dtype, device=first)}
        return calib, {k: Adam(lr, v) for k, v in calib.items()}

    def step(calib: dict, opt_state: dict, images: torch.Tensor,
             targets: torch.Tensor):
        targets = torch.as_tensor(targets, dtype=torch.int64)
        leaves = {k: v.detach().requires_grad_(True) for k, v in
                  calib.items()}
        shards = list(zip(shard_batch(mesh, images),
                          shard_batch(mesh, targets)))
        losses = []
        with torch.enable_grad():
            # every copy between cards is made before any shard's work is
            # enqueued (it runs behind the source card's queue)
            here = {x.device: {k: v.to(x.device) for k, v in leaves.items()}
                    for (_, x), _ in shards}
            for (r, x), (_, t) in shards:
                c = here[x.device]
                attr = _ig_attr(forwards[r], x, t, ig_steps)
                attr = attr * c["scale"] + c["bias"]
                ins, dele = _soft_curves(forwards[r], x, attr, t, n_thresh)
                losses.append((1.0 - ins.mean(1)) + dele.mean(1))
            loss = torch.cat([v.to(first) for v in losses]).mean()
            grads = torch.autograd.grad(loss, list(leaves.values()))
        new = {k: opt_state[k].step(v.detach(), g)
               for (k, v), g in zip(leaves.items(), grads)}
        return new, opt_state, loss.detach()

    return step, init_fn
