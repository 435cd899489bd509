"""Quickshift parent links: a hand-written CUDA kernel and its plain
version.

Replaces ``xai_tpu/kernels/quickshift_pallas.py``
``quickshift_parents_pallas`` (the Pallas TPU kernel) and, off the TPU,
the XLA patches form ``_quickshift_device_b`` it stands beside.  The LAB
conversion and the ``ratio`` scale stay in PyTorch
(``ops/quickshift.py lab_planes``), outside the kernel, as they stay
outside the ``pallas_call``.  The kernel (``csrc/quickshift.cu``) runs the
density phase, then the parent phase, over shared-memory tiles of the LAB
planes with a ``w``-pixel halo of sentinels.

It is bound by instruction issue: ~29.6 M (pixel, offset) pairs per phase
at 224 px and w = 12, each with a fixed sequence of rounded float
operations, because the parents must be bit-exact.  The first version
(one thread per pixel, three or four shared loads a pair, a run-time
window, 196 blocks for 132 SMs at one image) ran at 4.2x the bound that
``kernels/bounds.py`` counts.  The kernel now keeps a pixel's LAB and
density in one float4, blocks registers along y (a thread owns one or two
pixels, one above another, and each neighbour it loads serves both),
instantiates LIME's window (w = wd = 12) at compile time, and picks the
larger of two tiles (compile-time constants) where its blocks spread
evenly over the SMs.  It visits every pixel's window in row-major order,
as the plain version sums it, so the densities are the same floats.  The
source note gives the design, ``PERF.md`` the tile sweep that chose the
tiles.

:func:`quickshift_parents` runs the plain version for CPU tensors; for
CUDA tensors it launches the kernel or raises.  Its parents are
bit-exact against the plain version on the card (``chip_smoke.py``).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ..ops.quickshift import lab_planes, parents_plain
from ..utils import trace
from . import _build

# the largest window the kernel takes; its run-time instantiation serves
# every window but LIME's, and a block's shared memory grows as (32 + 2w)^2
MAX_W = 18


@functools.lru_cache(maxsize=1)
def _entry():
    lib = _build.load("quickshift")
    fn = lib.xai_quickshift_parents
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 5
                   + [ctypes.c_float] * 2 + [ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib, fn


def parents_density(lab: torch.Tensor, w: int, wd: int, inv2s2: float,
                    max_d2: float):
    """Launch the kernel on LAB * ratio planes ``lab`` [B, 3, H, W] float32
    on the card.  Returns (parents [B, H, W] int32, density [B, H, W]
    float32)."""
    if not 1 <= w <= MAX_W or not 0 <= wd <= w:
        raise ValueError(f"quickshift kernel: need 1 <= w <= {MAX_W} and "
                         f"0 <= wd <= w, got w={w}, wd={wd}")
    if lab.device.type != "cuda":
        raise ValueError(f"quickshift kernel: needs a CUDA tensor, got "
                         f"{lab.device}")
    if (lab.dtype != torch.float32 or lab.dim() != 4 or lab.shape[1] != 3
            or not lab.is_contiguous()):
        raise ValueError("quickshift kernel: need contiguous float32 "
                         f"[B, 3, H, W] planes, got {lab.dtype} "
                         f"{tuple(lab.shape)}")
    b, _, h, wi = lab.shape
    if b > 65535 or lab.numel() >= 2 ** 31:
        raise ValueError(f"quickshift kernel: {tuple(lab.shape)} exceeds "
                         "the grid")
    dens = torch.empty((b, h, wi), dtype=torch.float32, device=lab.device)
    out = torch.empty((b, h, wi), dtype=torch.int32, device=lab.device)
    if out.numel() == 0:
        return out, dens
    lib, fn = _entry()
    # the guard gives the caller back its current device: the C entry
    # sets lab's (cudaSetDevice)
    with torch.cuda.device(lab.device):
        err = fn(lab.data_ptr(), dens.data_ptr(), out.data_ptr(), b, h, wi,
                 w, wd, inv2s2, max_d2, lab.device.index,
                 torch.cuda.current_stream(lab.device).cuda_stream)
    _build.check(lib, err, "quickshift_parents")
    trace.count_launches(quickshift_parents)
    return out, dens


def quickshift_parents(rgbs: torch.Tensor, inv2s2: float, max_d2: float,
                       ratio: float, *, w: int, wd: int) -> torch.Tensor:
    """[B, H, W, 3] sRGB in [0, 1] -> [B, H, W] int32 flat parent indices
    (the contract of ``quickshift_parents_pallas``).  CPU tensors take
    the plain version; CUDA tensors the kernel."""
    if rgbs.device.type == "cpu":
        return parents_plain(rgbs, w, wd, ratio, inv2s2, max_d2)
    if rgbs.device.type != "cuda":
        raise ValueError(f"quickshift_parents: unsupported device "
                         f"{rgbs.device}")
    if rgbs.dim() != 4 or rgbs.shape[-1] != 3:
        raise ValueError(f"quickshift_parents: need [B, H, W, 3], got "
                         f"{tuple(rgbs.shape)}")
    return parents_density(lab_planes(rgbs, ratio), w, wd, inv2s2,
                           max_d2)[0]


quickshift_parents.launches = 0
