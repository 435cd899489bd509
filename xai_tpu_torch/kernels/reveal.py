"""The ranked-reveal image batch: a hand-written CUDA kernel and its plain
version.

Replaces ``xai_tpu/kernels/reveal.py`` ``pallas_reveal_batch`` (the Pallas
TPU kernel) and, on the main paths, the inline ``jnp.where`` of
``xai_tpu/metrics/curves.py`` ``_curves_core`` and of
``xai_tpu/parallel/sharded_battery.py`` ``batched_curves``.  For each
image ``b`` and each step ``s`` of a chunk the battery feeds the model
``where(flip[b] <= steps[s], finish[b], start[b])``; the kernel
(``csrc/reveal.cu``) writes that ``[B, S, C, H, W]`` batch in the model's
NCHW layout with 16-byte stores, one launch for all images.  It is bound
by the bytes it writes: 27.1 MB an image for a 45-step 224x224x3 chunk,
~8.5 us an image at 3.35 TB/s.

:func:`reveal_batch` runs the plain ``torch.where`` for CPU tensors; for
CUDA tensors it launches the kernel or raises.  :func:`reveal_chunk` is
its one-image view.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ..utils import trace
from . import _build


@functools.lru_cache(maxsize=1)
def _entry():
    lib = _build.load("reveal")
    fn = lib.xai_reveal_batch
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib, fn


def reveal_batch_plain(start, finish, flip, steps) -> torch.Tensor:
    """start/finish [B, C, H, W], flip [B, H, W] int, steps [S] int ->
    [B, S, C, H, W]."""
    return torch.where(flip[:, None, None] <= steps[None, :, None, None,
                                                    None],
                       finish[:, None], start[:, None])


def reveal_batch(start: torch.Tensor, finish: torch.Tensor,
                 flip: torch.Tensor, steps: torch.Tensor) -> torch.Tensor:
    """The images of steps ``steps`` of one reveal pass for every image,
    ``[B, S, C, H, W]`` float32.  CPU tensors take the plain version; CUDA
    tensors the kernel, one launch."""
    if start.device.type == "cpu":
        return reveal_batch_plain(start, finish, flip, steps)
    if start.device.type != "cuda":
        raise ValueError(f"reveal_batch: unsupported device {start.device}")
    b, c, h, w = start.shape
    tensors = {"start": start, "finish": finish, "flip": flip,
               "steps": steps}
    for name, t in tensors.items():
        if t.device != start.device or not t.is_contiguous():
            raise ValueError(f"reveal_batch: {name} must be contiguous on "
                             f"{start.device}")
    if (start.dtype != torch.float32 or finish.dtype != torch.float32
            or finish.shape != start.shape):
        raise ValueError("reveal_batch: start/finish must be float32 "
                         f"[B, C, H, W] alike, got {start.dtype} "
                         f"{tuple(start.shape)}, {finish.dtype} "
                         f"{tuple(finish.shape)}")
    if flip.dtype != torch.int32 or flip.shape != (b, h, w):
        raise ValueError(f"reveal_batch: flip must be int32 [{b}, {h}, {w}]")
    if steps.dtype != torch.int32 or steps.dim() != 1:
        raise ValueError("reveal_batch: steps must be int32 [S]")
    s = steps.shape[0]
    if s > 65535 or b > 65535 or c * h * w >= 2 ** 31:
        raise ValueError("reveal_batch: too many images, steps or elements")
    out = torch.empty((b, s, c, h, w), dtype=start.dtype, device=start.device)
    if out.numel() == 0:
        return out
    lib, fn = _entry()
    # the guard gives the caller back its current device: the C entry
    # sets start's (cudaSetDevice)
    with torch.cuda.device(start.device):
        err = fn(start.data_ptr(), finish.data_ptr(), flip.data_ptr(),
                 steps.data_ptr(), out.data_ptr(), b, s, c, h * w,
                 start.device.index,
                 torch.cuda.current_stream(start.device).cuda_stream)
    _build.check(lib, err, "reveal_batch")
    trace.count_launches(reveal_batch)
    return out


reveal_batch.launches = 0


def reveal_chunk(start: torch.Tensor, finish: torch.Tensor,
                 flip: torch.Tensor, steps: torch.Tensor) -> torch.Tensor:
    """One image's reveal batch: start/finish [C, H, W], flip [H, W] ->
    ``[S, C, H, W]``; the ``B = 1`` view of :func:`reveal_batch`."""
    return reveal_batch(start[None], finish[None], flip[None], steps)[0]
