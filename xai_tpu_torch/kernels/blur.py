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
the TPU's Toeplitz-matmul form does not carry over.  That fused kernel
is instantiated for every odd klen up to ``MAX_FUSED_KLEN``; a wider
klen (MDA's adaptive blur reaches 103) takes two launches, a row pass
into a scratch plane and a column pass, with klen a run-time value, so
every odd klen runs, as xai_tpu's ``make_blur_fn`` takes any.

:func:`blur_planes` runs the plain version (the dense depthwise
``F.conv2d`` of ``gkern``) for CPU tensors; for CUDA tensors it launches
the kernel or raises.  ``blur_planes.launches`` counts kernel launches:
1 a call up to ``MAX_FUSED_KLEN``, 2 above it.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..ops.blur import gaussian_blur, gkern
from ..utils import trace
from . import _build

# csrc/blur.cu instantiates its fused kernel for every odd klen up to it
MAX_FUSED_KLEN = 63


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


@functools.lru_cache(maxsize=16)
def _device_factors(klen: int, nsig: float, device: torch.device):
    """The wide path's taps, copied to ``device`` once: ``(col, row)``."""
    return tuple(torch.as_tensor(t, device=device)
                 for t in _factors(klen, nsig))


@functools.lru_cache(maxsize=1)
def _entry():
    lib = _build.load("blur")
    fused = lib.xai_blur_planes
    fused.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    fused.restype = ctypes.c_int
    wide = lib.xai_blur_planes_wide
    wide.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    wide.restype = ctypes.c_int
    return lib, fused, wide


def blur_planes_plain(x: torch.Tensor, klen: int = 31, nsig: float = 31.0
                      ) -> torch.Tensor:
    """[N, H, W] -> [N, H, W], the dense 'same' zero-padded conv."""
    return gaussian_blur(x[:, None], klen, nsig)[:, 0]


def blur_planes(x: torch.Tensor, klen: int = 31, nsig: float = 31.0
                ) -> torch.Tensor:
    """Blur every plane of ``x`` ``[N, H, W]`` float32 with ``gkern(klen,
    nsig)`` for any odd ``klen``.  CPU tensors take the plain version;
    CUDA tensors the kernel."""
    if x.device.type == "cpu":
        return blur_planes_plain(x, klen, nsig)
    if x.device.type != "cuda":
        raise ValueError(f"blur_planes: unsupported device {x.device}")
    if x.dtype != torch.float32 or x.dim() != 3 or not x.is_contiguous():
        raise ValueError("blur_planes: need a contiguous float32 [N, H, W] "
                         f"tensor, got {x.dtype} {tuple(x.shape)} "
                         f"contiguous={x.is_contiguous()}")
    if klen % 2 == 0 or klen < 1:
        raise ValueError(f"blur_planes: klen must be odd and positive, "
                         f"got {klen}")
    n, h, w = x.shape
    if n > 65535 or n * h * w >= 2 ** 31:
        raise ValueError(f"blur_planes: {tuple(x.shape)} exceeds the grid")
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    lib, fused, wide = _entry()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    # the guard gives the caller back its current device: the C entry
    # sets x's (cudaSetDevice)
    with torch.cuda.device(x.device):
        if klen <= MAX_FUSED_KLEN:
            col, row = _factors(klen, float(nsig))     # host taps, by value
            err = fused(x.data_ptr(), out.data_ptr(), col.ctypes.data,
                        row.ctypes.data, n, h, w, klen, x.device.index,
                        stream)
            launched = 1
        else:
            col, row = _device_factors(klen, float(nsig), x.device)
            mid = torch.empty_like(x)
            err = wide(x.data_ptr(), mid.data_ptr(), out.data_ptr(),
                       col.data_ptr(), row.data_ptr(), n, h, w, klen,
                       x.device.index, stream)
            launched = 2
    _build.check(lib, err, "blur_planes")
    trace.count_launches(blur_planes, launched)
    return out


blur_planes.launches = 0


def separable_blur(x: torch.Tensor, klen: int = 31, nsig: float = 31.0
                   ) -> torch.Tensor:
    """``[B, H, W, C]`` -> blurred alike: the layout of xai_tpu's
    ``separable_blur`` and ``pallas_blur``, each (image, channel) plane
    through :func:`blur_planes`."""
    b, h, w, c = x.shape
    planes = x.permute(0, 3, 1, 2).reshape(b * c, h, w).contiguous()
    return blur_planes(planes, klen, nsig).reshape(b, c, h, w).permute(
        0, 2, 3, 1)
