"""The ResNet post-convolution epilogue: a hand-written CUDA kernel and its
plain version.

Replaces no TPU kernel.  After each convolution the ResNet runs FoldedBN
(``x * scale + bias`` per channel), on a block's last convolution the
residual add (the residual through the downsample's FoldedBN where there
is one), and ReLU.  XLA fused these into one pass on the TPU; eager
PyTorch runs each as its own elementwise pass over the activation.  The
kernel (``csrc/bn_act.cu``) computes the whole epilogue in one pass that
reads the convolution's output (and the residual) once and writes once,
bit-exact with the op sequence: every multiply and add rounds as the
PyTorch op does, and ReLU passes NaN through as ``torch.relu`` does.

:func:`bn_act` runs the plain version for CPU tensors; for CUDA tensors it
launches the kernel, one launch a call, or raises.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch
import torch.nn.functional as F

from ..utils import trace
from . import _build

# the forms of csrc/bn_act.cu: no residual, a residual, a residual through
# its own FoldedBN
_PLAIN, _RESIDUAL, _RESIDUAL_BN = 0, 1, 2


@functools.lru_cache(maxsize=1)
def _entry():
    lib = _build.load("bn_act")
    fn = lib.xai_bn_act
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib, fn


def bn_act_plain(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                 residual: Optional[torch.Tensor] = None,
                 residual_scale: Optional[torch.Tensor] = None,
                 residual_bias: Optional[torch.Tensor] = None
                 ) -> torch.Tensor:
    """``relu(x * scale + bias [+ residual])`` per channel of an NCHW
    ``x``, the residual first through ``residual * residual_scale +
    residual_bias`` where those are given: the op sequence of
    ``models/resnet.py``'s FoldedBN, residual add and ReLU."""
    y = x * scale[:, None, None] + bias[:, None, None]
    if residual is not None:
        if residual_scale is not None:
            residual = (residual * residual_scale[:, None, None]
                        + residual_bias[:, None, None])
        y = y + residual
    return F.relu(y)


def bn_act(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
           residual: Optional[torch.Tensor] = None,
           residual_scale: Optional[torch.Tensor] = None,
           residual_bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The epilogue of :func:`bn_act_plain` as a new ``[N, C, H, W]``
    float32 tensor.  CPU tensors take the plain version; CUDA tensors the
    kernel, one launch."""
    if x.device.type == "cpu":
        return bn_act_plain(x, scale, bias, residual, residual_scale,
                            residual_bias)
    if x.device.type != "cuda":
        raise ValueError(f"bn_act: unsupported device {x.device}")
    if (residual_scale is None) != (residual_bias is None) or (
            residual is None and residual_scale is not None):
        raise ValueError("bn_act: residual_scale and residual_bias come "
                         "together, with a residual")
    if x.dim() != 4:
        raise ValueError(f"bn_act: x must be [N, C, H, W], got "
                         f"{tuple(x.shape)}")
    n, c, h, w = x.shape
    tensors = {"x": (x, x.shape), "scale": (scale, (c,)),
               "bias": (bias, (c,))}
    if residual is not None:
        tensors["residual"] = (residual, x.shape)
    if residual_scale is not None:
        tensors["residual_scale"] = (residual_scale, (c,))
        tensors["residual_bias"] = (residual_bias, (c,))
    for name, (t, shape) in tensors.items():
        if t.device != x.device or not t.is_contiguous():
            raise ValueError(f"bn_act: {name} must be contiguous on "
                             f"{x.device}")
        if t.dtype != torch.float32 or t.shape != shape:
            raise ValueError(f"bn_act: {name} must be float32 "
                             f"{tuple(shape)}, got {t.dtype} "
                             f"{tuple(t.shape)}")
    # the kernel indexes the flat tensor in 32 bits
    if x.numel() >= 2 ** 31:
        raise ValueError("bn_act: too many elements")
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    form = (_PLAIN if residual is None else
            _RESIDUAL if residual_scale is None else _RESIDUAL_BN)
    ptr = (lambda t: None if t is None else t.data_ptr())
    lib, fn = _entry()
    # the guard gives the caller back its current device: the C entry
    # sets x's (cudaSetDevice)
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), scale.data_ptr(), bias.data_ptr(),
                 ptr(residual), ptr(residual_scale), ptr(residual_bias),
                 out.data_ptr(), form, n, c, h * w, x.device.index,
                 torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, err, "bn_act")
    trace.count_launches(bn_act)
    return out


bn_act.launches = 0
