"""Quickshift superpixels on the device, LIME's segmenter.

Counterpart of ``xai_tpu/ops/quickshift_jax.py`` (Vedaldi & Soatto, ECCV
2008; lime/wrappers/scikit_image.py:87).  Two stencil phases over the
``(2w+1)^2`` window of every pixel, on the LAB image scaled by ``ratio``:

- Parzen density: the sum over the window of ``exp(-d2 * inv2s2)``, where
  ``d2`` is the squared colour distance plus the squared spatial offset;
- parent link: the nearest window pixel (Chebyshev radius ``<= wd``, not
  the pixel itself) with strictly higher density and ``d2 < max_d2``, the
  earliest offset on ties; a pixel without one is its own parent.

On a CUDA tensor the phases run as the hand-written kernel of
``kernels/quickshift.py``; :func:`parents_plain` is its plain version, the
two loops over the window offsets written with PyTorch elementwise ops.
The parents become labels by pointer jumping and a ``cumsum`` rank
(:func:`parents_to_labels_batch`, on the device) or by the host
compaction :func:`_compact`; both give labels in ascending-root order.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

_COLOR_FILL = 1e6      # padded LAB: exp(-d2 * inv2s2) of it is +0.0
_DENS_FILL = -1e30     # padded density: never a higher-density parent


def rgb2lab(rgb: torch.Tensor) -> torch.Tensor:
    """[..., 3] sRGB in [0, 1] -> CIELAB (D65), the skimage form.  The
    cube root is ``t ** (1/3)`` (within 1e-4 of JAX's ``cbrt`` in LAB)."""
    c = torch.where(rgb > 0.04045, ((rgb + 0.055) / 1.055) ** 2.4,
                    rgb / 12.92)
    r, g, b = c.unbind(-1)
    x = (0.412453 * r + 0.357580 * g + 0.180423 * b) / 0.95047
    y = 0.212671 * r + 0.715160 * g + 0.072169 * b
    z = (0.019334 * r + 0.119193 * g + 0.950227 * b) / 1.08883

    def f(t):
        return torch.where(t > 0.008856, t ** (1.0 / 3.0),
                           7.787 * t + 16.0 / 116.0)

    fx, fy, fz = f(x), f(y), f(z)
    return torch.stack([116.0 * fy - 16.0, 500.0 * (fx - fy),
                        200.0 * (fy - fz)], dim=-1).to(torch.float32)


def lab_planes(rgbs: torch.Tensor, ratio: float) -> torch.Tensor:
    """[B, H, W, 3] sRGB -> contiguous LAB * ratio planes [B, 3, H, W],
    the input of the stencil phases."""
    lab = rgb2lab(rgbs.to(torch.float32)) * float(np.float32(ratio))
    return lab.permute(0, 3, 1, 2).contiguous()


def _offsets(w: int):
    """The window offsets (dy, dx) in row-major order, as the kernels
    visit them."""
    for dy in range(-w, w + 1):
        for dx in range(-w, w + 1):
            yield dy, dx


def _dist2(pad, c, dy, dx, w, h, wi):
    """Squared joint distance from every pixel to its (dy, dx) neighbour:
    ``((d0^2 + d1^2) + d2^2) + spatial``, each step rounded on its own, as
    the kernel computes it."""
    n = pad[:, :, w + dy:w + dy + h, w + dx:w + dx + wi]
    d = [n[:, i] - c[:, i] for i in range(3)]
    return ((d[0] * d[0] + d[1] * d[1]) + d[2] * d[2]) + float(dy * dy
                                                                 + dx * dx)


def parents_density_plain(lab: torch.Tensor, w: int, wd: int,
                          inv2s2: float, max_d2: float):
    """The plain version of the quickshift kernel.  lab: [B, 3, H, W]
    LAB * ratio planes.  Returns (parents [B, H, W] int32 flat indices,
    density [B, H, W] float32).

    Two sequential loops over the window, memory [B, H, W] per step.
    Out-of-image neighbours read the sentinels of the Pallas kernel
    (``xai_tpu/kernels/quickshift_pallas.py``), as the CUDA kernel's halo
    does: their density term is exactly +0.0 and they never pass the
    parent test."""
    b, _, h, wi = lab.shape
    inv2s2 = float(np.float32(inv2s2))
    max_d2 = float(np.float32(max_d2))
    pad = F.pad(lab, (w, w, w, w), value=_COLOR_FILL)
    dens = torch.zeros((b, h, wi), dtype=torch.float32, device=lab.device)
    for dy, dx in _offsets(w):
        d2 = _dist2(pad, lab, dy, dx, w, h, wi)
        dens = dens + torch.exp(-d2 * inv2s2)

    dpad = F.pad(dens, (w, w, w, w), value=_DENS_FILL)
    best = torch.full_like(dens, float("inf"))
    best_off = torch.zeros((b, h, wi), dtype=torch.int32, device=lab.device)
    for dy, dx in _offsets(w):
        if max(abs(dy), abs(dx)) > wd or (dy == 0 and dx == 0):
            continue                   # outside the radius: never a parent
        d2 = _dist2(pad, lab, dy, dx, w, h, wi)
        nbd = dpad[:, w + dy:w + dy + h, w + dx:w + dx + wi]
        # strict < keeps the earliest offset on ties (argmin's first min)
        upd = (nbd > dens) & (d2 < max_d2) & (d2 < best)
        best = torch.where(upd, d2, best)
        best_off = torch.where(upd, dy * wi + dx, best_off)
    base = torch.arange(h * wi, dtype=torch.int32,
                        device=lab.device).view(h, wi)
    return base + best_off, dens


def parents_plain(rgbs: torch.Tensor, w: int, wd: int, ratio: float,
                  inv2s2: float, max_d2: float) -> torch.Tensor:
    """[B, H, W, 3] sRGB in [0, 1] -> [B, H, W] int32 flat parent indices,
    the contract of ``xai_tpu``'s ``_quickshift_device_b``."""
    return parents_density_plain(lab_planes(rgbs, ratio), w, wd, inv2s2,
                                 max_d2)[0]


def _parents_batch(imgs: torch.Tensor, w: int, wd: int, ratio: float,
                   inv2s2: float, max_d2: float) -> torch.Tensor:
    """Parents of a [B, H, W, 3] batch: the CUDA kernel for CUDA tensors,
    the plain version for CPU tensors."""
    from ..kernels.quickshift import quickshift_parents
    return quickshift_parents(imgs, inv2s2, max_d2, ratio, w=w, wd=wd)


def _compact(parent: np.ndarray, h: int, wi: int) -> np.ndarray:
    """Host tail: path-compress to roots (pointer jumping), then compact
    the root ids to consecutive labels."""
    for _ in range(64):
        nxt = parent[parent]
        if np.array_equal(nxt, parent):
            break
        parent = nxt
    _, labels = np.unique(parent, return_inverse=True)
    return labels.reshape(h, wi).astype(np.int32)


def parents_to_labels_batch(parents: torch.Tensor):
    """[B, H, W] int32 parent maps -> (labels [B, H*W] int32, counts [B]
    int64), on the parents' device.

    16 pointer-jump doublings reach the root of any chain up to 2^16
    pixels; ``cumsum(is_root)`` then numbers the roots in ascending index
    order, the order ``np.unique`` gives :func:`_compact`."""
    p = parents.reshape(parents.shape[0], -1).long()
    for _ in range(16):
        p = torch.gather(p, 1, p)
    idx = torch.arange(p.shape[1], device=p.device)
    rank = torch.cumsum((p == idx).long(), dim=1)
    return (torch.gather(rank, 1, p) - 1).int(), rank[:, -1]


def quickshift_params(kernel_size: float, max_dist: float):
    """(w, wd, inv2s2, max_d2) of a quickshift configuration, as
    ``xai_tpu`` derives them."""
    w = max(1, int(3.0 * kernel_size))
    wd = min(w, int(np.ceil(max_dist)))
    return (w, wd, float(np.float32(1.0 / (2.0 * kernel_size * kernel_size))),
            float(np.float32(max_dist * max_dist)))


def quickshift_device_batch(images, ratio: float = 0.2,
                            kernel_size: float = 4.0, max_dist: float = 200.0,
                            device=None) -> np.ndarray:
    """[B, H, W, 3] float images in [0, 1] -> [B, H, W] int32 labels.  The
    stencil phases run on ``device`` (CUDA unless ``device="cpu"``; a
    tensor's own device if ``images`` is one); the label compaction runs
    on the host."""
    if not isinstance(images, torch.Tensor):
        from ..runners.common import resolve_device
        images = torch.as_tensor(np.asarray(images, np.float32),
                                 device=resolve_device(device))
    b, h, wi = images.shape[:3]
    w, wd, inv2s2, max_d2 = quickshift_params(kernel_size, max_dist)
    parents = _parents_batch(images.to(torch.float32), w, wd, ratio, inv2s2,
                             max_d2).reshape(b, -1).cpu().numpy()
    return np.stack([_compact(parents[i], h, wi) for i in range(b)])


def quickshift_device(image, ratio: float = 0.2, kernel_size: float = 4.0,
                      max_dist: float = 200.0, device=None) -> np.ndarray:
    """[H, W, 3] float image in [0, 1] -> [H, W] int32 segment labels."""
    if not isinstance(image, torch.Tensor):
        image = np.asarray(image)
    return quickshift_device_batch(image[None], ratio, kernel_size,
                                   max_dist, device)[0]
