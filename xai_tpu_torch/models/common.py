"""The model interface every attribution method and metric builds on.

Counterpart of ``xai_tpu/models/common.py``.  A bundle wraps an
``nn.Module`` whose parameters are frozen (``requires_grad=False``): every
gradient the methods take is with respect to the input only, as the JAX
VJP is, so a backward pass never computes weight gradients.

All bundle functions take NCHW batches; the public methods and metrics
transpose from ``[H, W, C]`` once at their boundary.
"""
from __future__ import annotations

import copy
import dataclasses
import itertools

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
        self._casts = {}

    def _first_tensor(self):
        return next(itertools.chain(self.module.parameters(),
                                    self.module.buffers()), None)

    @property
    def dtype(self) -> torch.dtype:
        """The dtype the module computes in: its first parameter's (or
        buffer's), float32 for a module that holds neither."""
        p = self._first_tensor()
        return torch.float32 if p is None else p.dtype

    @property
    def device(self) -> torch.device:
        p = self._first_tensor()
        return torch.device("cpu") if p is None else p.device

    def cast(self, dtype) -> "ModelBundle":
        """The bundle with its module in ``dtype`` (``None``: this one).
        The copy is made once per dtype and kept on the bundle; the float32
        module is never cast in place — the counterpart of xai_tpu's
        ``_cast_params_cached``."""
        if dtype is None or dtype == self.dtype:
            return self
        if dtype not in self._casts:
            self._casts[dtype] = ModelBundle(
                self.meta, copy.deepcopy(self.module).to(dtype))
        return self._casts[dtype]

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

    def score_and_grad(self, x: torch.Tensor, target):
        """Batched d logit[target] / d input — the reference's
        ``getGradientsParallel``.  ``target`` is one class for every row,
        or an int64 ``[N]`` tensor of one class per row.  One batched
        forward and one backward: each score depends only on its own
        image, so the gradient of the sum is the per-sample gradient.
        Scores are taken from float32 logits and the gradient comes back
        float32 whatever the module's dtype, as xai_tpu's ``_flat_grads``
        does.  Returns (grads, scores)."""
        x = x.detach().requires_grad_(True)
        with torch.enable_grad():
            scores = target_scores(self.apply(x).float(), target)
            (g,) = torch.autograd.grad(scores.sum(), x)
        return g.float(), scores.detach()


def target_scores(logits: torch.Tensor, target) -> torch.Tensor:
    """``[N, classes]`` -> ``[N]``: each row's entry at ``target``, one
    class or an int64 ``[N]`` tensor of one class per row (xai_tpu's
    ``take_along_axis``)."""
    if isinstance(target, torch.Tensor):
        return logits.gather(1, target.view(-1, 1))[:, 0]
    return logits[:, target]
