"""LayerNorm over the last axis: a hand-written CUDA kernel and its plain
version.

Replaces no TPU kernel.  ``models/common.py LayerNorm`` computes flax's
LayerNorm (float32 statistics with the fast variance max(0, E[x^2] -
E[x]^2), then ``(x - mean) * (rsqrt(var + eps) * scale) + bias``); XLA
fused it into one pass on the TPU, and eager PyTorch runs it as ten
separate passes.  The kernel (``csrc/layernorm.cu``) reads each row once
and writes it once, with the same operations in the same order, each
rounded as the PyTorch op rounds: it differs from the separate ops only by
the order of its two sums.

:func:`layernorm` runs the plain version for CPU tensors; for CUDA tensors
it launches the kernel, one launch a call, or raises.  :func:`fits` says
whether the kernel takes a call's operands.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from ..utils import trace
from . import _build

# the widest row csrc/layernorm.cu takes: 16 float4 quads a lane of a warp
MAX_WIDTH = 2048


@functools.lru_cache(maxsize=1)
def _entry():
    lib = _build.load("layernorm")
    fn = lib.xai_layernorm
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib, fn


def layernorm_plain(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                    eps: float) -> torch.Tensor:
    """flax's LayerNorm of ``x`` over its last axis as separate ops: the
    statistics in float32 with the fast variance, the affine map in
    float32, cast back to the promoted type of ``x`` and ``scale``."""
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    var = ((x32 * x32).mean(-1, keepdim=True) - mu * mu).clamp(min=0.0)
    mul = torch.rsqrt(var + eps) * scale.float()
    y = (x32 - mu) * mul + bias.float()
    return y.to(torch.promote_types(x.dtype, scale.dtype))


def _aligned(t: torch.Tensor) -> bool:
    return t.data_ptr() % 16 == 0


def fits(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor) -> bool:
    """Whether the kernel takes these operands: ``x`` a contiguous CUDA
    float32 tensor whose last axis C is a multiple of 4 up to
    :data:`MAX_WIDTH`, ``scale`` and ``bias`` contiguous float32 ``[C]``
    on its device, all 16-byte aligned."""
    if not (x.is_cuda and x.dtype == torch.float32 and x.dim() >= 1
            and x.is_contiguous()):
        return False
    c = x.shape[-1]
    return (0 < c <= MAX_WIDTH and c % 4 == 0 and _aligned(x) and all(
        t.device == x.device and t.dtype == torch.float32
        and t.shape == (c,) and t.is_contiguous() and _aligned(t)
        for t in (scale, bias)))


def layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              eps: float) -> torch.Tensor:
    """flax's LayerNorm of ``x`` over its last axis, as
    :func:`layernorm_plain` states it.  CPU tensors take the plain
    version; CUDA tensors that :func:`fits` takes the kernel, one launch,
    into a new float32 tensor of ``x``'s shape; other CUDA operands
    raise."""
    if x.device.type == "cpu":
        return layernorm_plain(x, scale, bias, eps)
    if x.device.type != "cuda":
        raise ValueError(f"layernorm: unsupported device {x.device}")
    if not fits(x, scale, bias):
        raise ValueError(
            f"layernorm: needs a contiguous, 16-byte aligned float32 x "
            f"with C a multiple of 4 up to {MAX_WIDTH} and float32 [C] "
            f"scale and bias on its device; got x {x.dtype} "
            f"{tuple(x.shape)}, scale {scale.dtype} {tuple(scale.shape)} "
            f"on {scale.device}, bias {bias.dtype} {tuple(bias.shape)} on "
            f"{bias.device}")
    c = x.shape[-1]
    rows = math.prod(x.shape[:-1])
    # the kernel counts rows in 32 bits
    if rows >= 2 ** 31:
        raise ValueError("layernorm: too many rows")
    out = torch.empty_like(x)
    if rows == 0:
        return out
    lib, fn = _entry()
    # the guard gives the caller back its current device: the C entry
    # sets x's (cudaSetDevice)
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), scale.data_ptr(), bias.data_ptr(),
                 out.data_ptr(), rows, c, eps, x.device.index,
                 torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, err, "layernorm")
    trace.count_launches(layernorm)
    return out


layernorm.launches = 0
