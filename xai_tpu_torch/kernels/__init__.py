"""The hand-written CUDA kernels and their plain PyTorch versions.

The counterparts of ``xai_tpu.kernels``: ``pallas_blur`` is
:func:`blur_planes` (``[N, H, W]`` planes; :func:`separable_blur` takes
xai_tpu's ``[B, H, W, C]``), ``pallas_reveal_batch`` is
:func:`reveal_batch` (``[B, C, H, W]`` images, ``[B, S, C, H, W]`` out).
Each runs its plain version on CPU tensors and launches its kernel on
CUDA tensors; nothing is built until the first launch.  LIME's
``quickshift_parents`` is in ``kernels/quickshift.py``.
"""
from .blur import blur_planes, separable_blur
from .reveal import reveal_batch

__all__ = ["separable_blur", "blur_planes", "reveal_batch"]
