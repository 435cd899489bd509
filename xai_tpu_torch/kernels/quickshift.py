"""Quickshift parent links: a hand-written CUDA kernel and its plain
version.

Replaces ``xai_tpu/kernels/quickshift_pallas.py``
``quickshift_parents_pallas`` (the Pallas TPU kernel) and, off the TPU,
the XLA patches form ``_quickshift_device_b`` it stands beside.  The LAB
conversion and the ``ratio`` scale stay in PyTorch
(``ops/quickshift.py lab_planes``), outside the kernel, as they stay
outside the ``pallas_call``.  The kernel (``csrc/quickshift.cu``) runs the
density phase, then the parent phase, one thread per pixel over a
shared-memory tile of the LAB planes with a ``w``-pixel halo.  It is
bound by operations: ~0.8 G FP32 lane operations per 224 px image at
w = 12, ~23 us on the H100; the source note gives the count.

:func:`quickshift_parents` runs the plain version for CPU tensors; for
CUDA tensors it launches the kernel or raises.  Its parents are
bit-exact against the plain version on the card (``chip_smoke.py``).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ..ops.quickshift import lab_planes, parents_plain
from . import _build

# the parent phase holds four (32 + 2w) x (8 + 2w) float tiles, which stay
# under the 48 KB of shared memory a block gets without opting in up to 18
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
    if lab.device.type != "cuda":
        raise ValueError(f"quickshift kernel: needs a CUDA tensor, got "
                         f"{lab.device}")
    if (lab.dtype != torch.float32 or lab.dim() != 4 or lab.shape[1] != 3
            or not lab.is_contiguous()):
        raise ValueError("quickshift kernel: need contiguous float32 "
                         f"[B, 3, H, W] planes, got {lab.dtype} "
                         f"{tuple(lab.shape)}")
    if not 1 <= w <= MAX_W or not 0 <= wd <= w:
        raise ValueError(f"quickshift kernel: need 1 <= w <= {MAX_W} and "
                         f"0 <= wd <= w, got w={w}, wd={wd}")
    b, _, h, wi = lab.shape
    if b > 65535 or lab.numel() >= 2 ** 31:
        raise ValueError(f"quickshift kernel: {tuple(lab.shape)} exceeds "
                         "the grid")
    dens = torch.empty((b, h, wi), dtype=torch.float32, device=lab.device)
    out = torch.empty((b, h, wi), dtype=torch.int32, device=lab.device)
    if out.numel() == 0:
        return out, dens
    lib, fn = _entry()
    err = fn(lab.data_ptr(), dens.data_ptr(), out.data_ptr(), b, h, wi, w,
             wd, inv2s2, max_d2, lab.device.index,
             torch.cuda.current_stream(lab.device).cuda_stream)
    _build.check(lib, err, "quickshift_parents")
    quickshift_parents.launches += 1
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
