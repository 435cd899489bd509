"""Gaussian blur substrate — exact parity with the reference's ``gkern``.

Counterpart of ``xai_tpu/ops/blur.py``.  The reference builds the kernel by
gaussian-filtering a dirac delta (MASTestFunctions.py:11-28) and applies it
with a stride-1 'same' zero-padded depthwise conv
(evaluatePerturbation.py:456-459).  :func:`gaussian_blur` is that dense
conv, the plain reference; :func:`make_blur_fn` returns the battery's
substrate function, which on CUDA tensors is the hand-written separable
kernel in ``kernels/blur.py``.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F
from scipy.ndimage import gaussian_filter


@functools.lru_cache(maxsize=32)
def gkern(klen: int, nsig: float) -> np.ndarray:
    """The reference's kernel as a [klen, klen] float32 array."""
    inp = np.zeros((klen, klen))
    inp[klen // 2, klen // 2] = 1
    k = gaussian_filter(inp, nsig)
    return k.astype("float32")


@functools.lru_cache(maxsize=32)
def _depthwise_weight(klen: int, nsig: float, channels: int,
                      dtype: torch.dtype, device: torch.device
                      ) -> torch.Tensor:
    # cached per device: a fresh host->device copy of a pageable array
    # would wait for the stream on every call
    k = torch.as_tensor(gkern(klen, nsig), dtype=dtype, device=device)
    return k.expand(channels, 1, klen, klen).contiguous()


def gaussian_blur(x: torch.Tensor, klen: int = 31, nsig: float = 31.0
                  ) -> torch.Tensor:
    """Dense depthwise 'same' blur of NCHW images (zero padding, matching
    torch ``conv2d(padding=klen//2)``)."""
    c = x.shape[1]
    weight = _depthwise_weight(klen, float(nsig), c, x.dtype, x.device)
    return F.conv2d(x, weight, padding=klen // 2, groups=c)


def make_blur_fn(klen: int = 31, nsig: float = 31.0):
    """substrate_fn(x_nchw) -> blurred, the metric battery's insertion
    substrate (evaluatePerturbation.py:456-471).  Every (image, channel)
    plane goes through ``kernels.blur.blur_planes``: the CUDA kernel on
    the card, the dense conv on the CPU."""
    from ..kernels.blur import blur_planes

    def blur(x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        planes = x.reshape(b * c, h, w).contiguous()
        return blur_planes(planes, klen, nsig).reshape(b, c, h, w)

    return blur
