"""The substrate blur: a hand-written CUDA kernel and its plain version.

Replaces ``xai_tpu/kernels/blur_pallas.py`` ``pallas_blur`` (the Pallas
TPU kernel) and, on the main path, the XLA ``separable_blur`` it stands
beside.  The kernel (``csrc/blur.cu``) is a separable stencil, a row pass
then a column pass of klen fused multiply-adds per pixel.  At the main
path's ``[3, 224, 224]`` its work (1.2 MB, ~0.36 us at 3.35 TB/s) is
below the card's per-launch floor, so its time is the latency of one
block.  The first version (32 x 32 tiles: 147 blocks for 132 SMs, a
serial tile load, two shared-memory reads per FMA) took ~11 us there on
an NVIDIA H100 80GB HBM3 at 700 W.
The kernel now runs 32 x 40 tiles (126 blocks, one per SM), copies the
tile with cp.async, keeps the taps in kernel parameters and slides
register windows along rows and down columns; the source note says why
the TPU's Toeplitz-matmul form does not carry over.

:func:`blur_planes` runs the plain version (the dense depthwise
``F.conv2d`` of ``gkern``) for CPU tensors; for CUDA tensors it launches
the kernel or raises.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..ops.blur import gaussian_blur, gkern
from . import _build

MAX_KLEN = 63       # csrc/blur.cu instantiates every odd klen up to it


@functools.lru_cache(maxsize=16)
def _factors(klen: int, nsig: float):
    """Rank-1 factors of ``gkern`` (SVD in float64, cast to float32):
    ``gkern ~= outer(col, row)`` to ~1e-10."""
    k = np.asarray(gkern(klen, nsig), np.float64)
    u, s, vt = np.linalg.svd(k)
    col = (u[:, 0] * np.sqrt(s[0]))
    row = (vt[0] * np.sqrt(s[0]))
    # fix sign (gaussian factors are positive)
    if col.sum() < 0:
        col, row = -col, -row
    return col.astype(np.float32), row.astype(np.float32)


@functools.lru_cache(maxsize=1)
def _entry():
    lib = _build.load("blur")
    fn = lib.xai_blur_planes
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib, fn


def blur_planes_plain(x: torch.Tensor, klen: int = 31, nsig: float = 31.0
                      ) -> torch.Tensor:
    """[N, H, W] -> [N, H, W], the dense 'same' zero-padded conv."""
    return gaussian_blur(x[:, None], klen, nsig)[:, 0]


def blur_planes(x: torch.Tensor, klen: int = 31, nsig: float = 31.0
                ) -> torch.Tensor:
    """Blur every plane of ``x`` ``[N, H, W]`` float32 with ``gkern(klen,
    nsig)``.  CPU tensors take the plain version; CUDA tensors the
    kernel."""
    if x.device.type == "cpu":
        return blur_planes_plain(x, klen, nsig)
    if x.device.type != "cuda":
        raise ValueError(f"blur_planes: unsupported device {x.device}")
    if x.dtype != torch.float32 or x.dim() != 3 or not x.is_contiguous():
        raise ValueError("blur_planes: need a contiguous float32 [N, H, W] "
                         f"tensor, got {x.dtype} {tuple(x.shape)} "
                         f"contiguous={x.is_contiguous()}")
    if klen % 2 == 0 or not 1 <= klen <= MAX_KLEN:
        raise ValueError(f"blur_planes: klen must be odd and <= {MAX_KLEN}")
    n, h, w = x.shape
    if n > 65535 or n * h * w >= 2 ** 31:
        raise ValueError(f"blur_planes: {tuple(x.shape)} exceeds the grid")
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    col, row = _factors(klen, float(nsig))     # host taps, by value
    lib, fn = _entry()
    err = fn(x.data_ptr(), out.data_ptr(), col.ctypes.data, row.ctypes.data,
             n, h, w, klen, x.device.index,
             torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, err, "blur_planes")
    blur_planes.launches += 1
    return out


blur_planes.launches = 0
