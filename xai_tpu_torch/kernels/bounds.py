"""The least time the card could take for each kernel's work.

A kernel's bound is the larger of two times: the bytes its function must
move (each input read once, each output written once) over the card's
memory rate, and the operations it does over the card's peak rate for
their type.  ``chip_smoke.py`` prints each kernel's time beside its bound;
the counts live here so that the CPU tests can hold them.

Peaks are the published ones of one NVIDIA H100 SXM at its 700 W limit
(NVIDIA's data sheet): 3.35 TB/s of HBM and 67 TFLOP/s of float32 outside
the tensor cores, which counts a fused multiply-add as two operations.
"""
from __future__ import annotations

from typing import Tuple

HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
# one FP32 lane operation per lane and clock: 128 lanes x 132 SMs x 1.98 GHz
F32_LANE_OPS_PER_S = F32_FLOPS_PER_S / 2
# the special-function units: 16 results per clock per SM (exp2 and the like)
MUFU_OPS_PER_S = 16 * 132 * 1.98e9


def window_span(n: int, r: int) -> int:
    """Sum over the n positions of an axis of the offsets in [-r, r] that
    stay on the axis."""
    return sum(min(i, r) + min(n - 1 - i, r) + 1 for i in range(n))


def quickshift_pairs(b: int, h: int, w_img: int, w: int,
                     wd: int) -> Tuple[int, int]:
    """(density pairs, parent pairs): the in-image (pixel, window offset)
    pairs of quickshift on a [b, h, w_img] batch; the parent phase leaves
    out each pixel itself."""
    dens = b * window_span(h, w) * window_span(w_img, w)
    parent = b * (window_span(h, wd) * window_span(w_img, wd) - h * w_img)
    return dens, parent


def quickshift_bound_ms(b: int, h: int, w_img: int, w: int,
                        wd: int) -> Tuple[float, int]:
    """(bound ms, lane operations) of quickshift on a [b, h, w_img]
    batch: each in-image (pixel, window offset) pair costs ~12 FP32 lane
    operations in the density phase (3 sub, 3 mul, 3 add, the scale, the
    accumulate and the exp's range reduction) and ~14 in the parent phase
    (the distance, 3 compares, 2 selects); bytes are the LAB planes read
    and the parents written."""
    dens, parent = quickshift_pairs(b, h, w_img, w, wd)
    ops = 12 * dens + 14 * parent
    nbytes = b * 4 * h * w_img * 4
    return max(ops / F32_LANE_OPS_PER_S,
               nbytes / HBM_BYTES_PER_S) * 1e3, ops


def quickshift_exp_ms(b: int, h: int, w_img: int, w: int) -> float:
    """Milliseconds the special-function units take for the density
    phase's exps, one per density pair.  They run beside the FP32 lanes,
    so this is a floor of its own, not part of the operations bound."""
    return quickshift_pairs(b, h, w_img, w, 0)[0] / MUFU_OPS_PER_S * 1e3


def blur_bound_ms(n: int, h: int, w: int, klen: int) -> Tuple[float, str]:
    """(bound ms, "bytes" or "operations") of the separable blur of
    [n, h, w] float32 planes: one read and one write of the planes, and
    two passes of klen fused multiply-adds per pixel."""
    t_bytes = 2 * n * h * w * 4 / HBM_BYTES_PER_S
    t_ops = n * h * w * 2 * klen * 2 / F32_FLOPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def reveal_bound_ms(s: int, c: int, h: int, w: int) -> float:
    """Bound ms of one reveal chunk (bytes): the start and finish images
    [c, h, w] float32, the flip steps [h, w] and the S steps read once,
    the [S, c, h, w] batch written once."""
    nbytes = (s * c * h * w + 2 * c * h * w) * 4 + (h * w + s) * 4
    return nbytes / HBM_BYTES_PER_S * 1e3
