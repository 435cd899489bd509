"""Guided Backprop / Grad-CAM / Guided Grad-CAM.

Counterpart of ``xai_tpu/methods/guided.py`` (the reference gets these from
captum 0.7, evaluatePerturbation.py:147-163).  The guided ReLU rule is a
``torch.autograd.Function``; the bundle's guided copy
(``ModelBundle.guided``) runs it in place of every ReLU.  The layer
gradient of Grad-CAM is the gradient with respect to a zero probe on the
layer (``ModelBundle.apply_probed``).

The public functions take a normalized ``[H, W, C]`` input on the model's
device; ``layer_gradcam`` and ``guided_grads`` take an NCHW batch with one
target per row, which the batched path (``methods/batch.py``) calls.
"""
from __future__ import annotations

import torch

from ..models.common import target_scores
from ..ops.resize import resize_bilinear, resize_nearest_exact


class GuidedReLU(torch.autograd.Function):
    """relu forward; backward passes only positive gradients through
    positive inputs (xai_tpu ``_guided_bwd``)."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.relu(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g * (g > 0) * (x > 0)


def guided_relu(x: torch.Tensor) -> torch.Tensor:
    return GuidedReLU.apply(x)


def guided_grads(bundle, x: torch.Tensor, targets) -> torch.Tensor:
    """d logit[target] / d input through the guided copy, ``[N, C, H, W]``
    float32."""
    return bundle.guided().score_and_grad(x.to(bundle.dtype), targets)[0]


def guided_backprop(bundle, x: torch.Tensor, target: int) -> torch.Tensor:
    """captum GuidedBackprop (evaluatePerturbation.py:154-158)."""
    return guided_grads(bundle, x.permute(2, 0, 1)[None], target)[0] \
        .permute(1, 2, 0)


def layer_gradcam(bundle, x: torch.Tensor, targets, layer: str = "layer4",
                  relu_attributions: bool = True) -> torch.Tensor:
    """captum LayerGradCam of an NCHW batch: weights = spatial mean of the
    layer's gradient, cam = relu(sum_k w_k A_k).  Returns ``[N, h, w]``
    float32."""
    x = x.to(bundle.dtype)
    with torch.no_grad():
        shape = bundle.apply_taps(x)[1][layer].shape
    probe = torch.zeros(shape, dtype=x.dtype, device=x.device,
                        requires_grad=True)
    with torch.enable_grad():
        logits, taps = bundle.apply_probed(x, {layer: probe})
        (g,) = torch.autograd.grad(
            target_scores(logits.float(), targets).sum(), probe)
    w = g.float().mean(dim=(2, 3), keepdim=True)
    cam = (w * taps[layer].detach().float()).sum(dim=1)
    return torch.relu(cam) if relu_attributions else cam


def grad_cam(bundle, x: torch.Tensor, target: int, layer: str = "layer4",
             img_hw: int = 224) -> torch.Tensor:
    """The driver's "gc": LayerGradCam on layer4, bilinear-resized to the
    input size and broadcast over 3 channels (evaluatePerturbation.py:
    147-153).  Returns [H, W, 3]."""
    cam = layer_gradcam(bundle, x.permute(2, 0, 1)[None], target, layer)[0]
    up = resize_bilinear(cam, (img_hw, img_hw))
    return up[..., None].expand(img_hw, img_hw, 3)


def guided_grad_cam(bundle, x: torch.Tensor, target: int,
                    layer: str = "layer4", img_hw: int = 224) -> torch.Tensor:
    """captum GuidedGradCam: GBP x nearest-upsampled positive CAM
    (evaluatePerturbation.py:159-163).  The CAM runs the plain model, GBP
    the guided copy."""
    cam = layer_gradcam(bundle, x.permute(2, 0, 1)[None], target, layer)[0]
    up = resize_nearest_exact(cam, (img_hw, img_hw))
    return guided_backprop(bundle, x, target) * up[..., None]
