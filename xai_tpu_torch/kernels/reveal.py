"""The ranked-reveal image batch: a hand-written CUDA kernel and its plain
version.

Replaces ``xai_tpu/kernels/reveal.py`` ``pallas_reveal_batch`` (the Pallas
TPU kernel) and, on the main path, the inline ``jnp.where`` of
``xai_tpu/metrics/curves.py`` ``_curves_core``.  For each step ``s`` of a
chunk the battery feeds the model ``where(flip <= steps[s], finish,
start)``; the kernel (``csrc/reveal.cu``) writes that ``[S, C, H, W]``
batch in the model's NCHW layout with 16-byte stores.  It is bound by the
bytes it writes: 27.1 MB for a 45-step 224x224x3 chunk, ~8 us at
3.35 TB/s.

:func:`reveal_chunk` runs the plain ``torch.where`` for CPU tensors; for
CUDA tensors it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build


@functools.lru_cache(maxsize=1)
def _entry():
    lib = _build.load("reveal")
    fn = lib.xai_reveal_chunk
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib, fn


def reveal_chunk_plain(start, finish, flip, steps) -> torch.Tensor:
    """start/finish [C, H, W], flip [H, W] int, steps [S] int ->
    [S, C, H, W]."""
    return torch.where(flip[None, None] <= steps[:, None, None, None],
                       finish, start)


def reveal_chunk(start: torch.Tensor, finish: torch.Tensor,
                 flip: torch.Tensor, steps: torch.Tensor) -> torch.Tensor:
    """The images of steps ``steps`` of one reveal pass, ``[S, C, H, W]``
    in the dtype of ``start``.  CPU tensors take the plain version; CUDA
    tensors the kernel."""
    if start.device.type == "cpu":
        return reveal_chunk_plain(start, finish, flip, steps)
    if start.device.type != "cuda":
        raise ValueError(f"reveal_chunk: unsupported device {start.device}")
    c, h, w = start.shape
    tensors = {"start": start, "finish": finish, "flip": flip,
               "steps": steps}
    for name, t in tensors.items():
        if t.device != start.device or not t.is_contiguous():
            raise ValueError(f"reveal_chunk: {name} must be contiguous on "
                             f"{start.device}")
    if (start.dtype != torch.float32 or finish.dtype != torch.float32
            or finish.shape != start.shape):
        raise ValueError("reveal_chunk: start/finish must be float32 "
                         f"[C, H, W] alike, got {start.dtype} "
                         f"{tuple(start.shape)}, {finish.dtype} "
                         f"{tuple(finish.shape)}")
    if flip.dtype != torch.int32 or flip.shape != (h, w):
        raise ValueError(f"reveal_chunk: flip must be int32 [{h}, {w}]")
    if steps.dtype != torch.int32 or steps.dim() != 1:
        raise ValueError("reveal_chunk: steps must be int32 [S]")
    s = steps.shape[0]
    if s > 65535 or c * h * w >= 2 ** 31:
        raise ValueError("reveal_chunk: too many steps or elements")
    out = torch.empty((s, c, h, w), dtype=start.dtype, device=start.device)
    if out.numel() == 0:
        return out
    lib, fn = _entry()
    err = fn(start.data_ptr(), finish.data_ptr(), flip.data_ptr(),
             steps.data_ptr(), out.data_ptr(), s, c, h * w,
             start.device.index,
             torch.cuda.current_stream(start.device).cuda_stream)
    _build.check(lib, err, "reveal_chunk")
    reveal_chunk.launches += 1
    return out


reveal_chunk.launches = 0
