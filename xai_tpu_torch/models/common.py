"""The model interface every attribution method and metric builds on.

Counterpart of ``xai_tpu/models/common.py``.  A bundle wraps an
``nn.Module`` whose parameters are frozen (``requires_grad=False``): every
gradient the methods take is with respect to the input only, as the JAX
VJP is, so a backward pass never computes weight gradients.

All bundle functions take NCHW batches; the public methods and metrics
transpose from ``[H, W, C]`` once at their boundary.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn as nn


@dataclasses.dataclass(frozen=True)
class ModelMeta:
    """Static metadata describing a model family member."""

    name: str                       # registry name, e.g. "R101"
    family: str                     # "cnn" | "vit" | "clip"
    img_hw: int = 224
    num_classes: int = 1000
    batch_size: int = 50            # reference's per-model chunk size


class ModelBundle:
    """A model as a frozen module plus its metadata.

    ``apply`` maps an NCHW batch to logits; ``apply_taps`` also returns the
    dict of stage activations (see resnet.py)."""

    def __init__(self, meta: ModelMeta, module: nn.Module):
        self.meta = meta
        self.module = module.eval().requires_grad_(False)

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        return self.module(x)

    # xai_tpu's bundle has both apply(params, x) and logits(x); with the
    # params inside the module they are one function
    logits = apply

    def apply_taps(self, x: torch.Tensor):
        return self.module(x, taps=True)

    @torch.inference_mode()
    def probs(self, x: torch.Tensor) -> torch.Tensor:
        return torch.softmax(self.apply(x), dim=-1)

    def predict(self, x: torch.Tensor):
        """(class, softmax prob) of the top-1 class for one image
        ``[1, C, H, W]`` — the reference's ``get_classifier_pred``."""
        pr = self.probs(x)[0]
        cls = int(torch.argmax(pr))
        return cls, float(pr[cls])

    def score_and_grad(self, x: torch.Tensor, target: int):
        """Batched d logit[target] / d input — the reference's
        ``getGradientsParallel``.  One batched forward and one backward:
        each score depends only on its own image, so the gradient of the
        sum is the per-sample gradient.  Returns (grads, scores)."""
        x = x.detach().requires_grad_(True)
        with torch.enable_grad():
            scores = self.apply(x)[:, target]
            (g,) = torch.autograd.grad(scores.sum(), x)
        return g, scores.detach()
