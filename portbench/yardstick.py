"""The benchmark's fixed arithmetic: the card's published peaks, the
least time of a reveal chunk, the union of device intervals, and the
FLOPs a cell's step needs.  Frozen copies live here, not in the
program, so that no change to the program moves the yardstick.

Peaks are the published ones of one NVIDIA H100 SXM at its 700 W limit
(NVIDIA's data sheet): 3.35 TB/s of HBM, and the highest dense rate of
each precision, a fused multiply-add counted as two operations: float32
67 TFLOP/s outside the tensor cores (TF32 off), TF32 494.7, bfloat16 and
float16 989.4, float8 1978.9.  A precision is named as the
configurations (``float32``) or the traffic mixes' ``attr_dtype``
(``f32``, ``bf16``) name it.
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS_PER_S = {"float32": 67e12, "tf32": 494.7e12,
                    "bfloat16": 989.4e12, "float16": 989.4e12,
                    "float8": 1978.9e12}
PRECISION_NAMES = {"f32": "float32", "bf16": "bfloat16"}


def peak_flops_per_s(precision: str) -> float:
    """The card's peak FLOP/s in ``precision``."""
    return PEAK_FLOPS_PER_S[PRECISION_NAMES.get(precision, precision)]


def reveal_bound_s(s: int, c: int, h: int, w: int, b: int = 1) -> float:
    """Least seconds of one reveal chunk of ``b`` images (bytes): the
    start and finish images ``[b, c, h, w]`` float32, the flip steps
    ``[b, h, w]`` and the ``s`` steps read once, the ``[b, s, c, h, w]``
    batch written once (a frozen copy of the program's
    ``kernels/bounds.py reveal_bound_ms``, in seconds)."""
    nbytes = b * (s * c * h * w + 2 * c * h * w + h * w) * 4 + s * 4
    return nbytes / HBM_BYTES_PER_S


def battery_points(img_hw: int) -> int:
    """Points of one reveal pass: ``img_hw`` pixels a step over an
    ``img_hw`` x ``img_hw`` image, and the start."""
    return (img_hw * img_hw + img_hw - 1) // img_hw + 1


def reveal_bound_per_step_s(img_hw: int, batch: int, chunk: int) -> float:
    """Least seconds of the reveal work of one step of ``batch`` images:
    3 passes, each ``battery_points`` images an image in chunks of
    ``chunk`` (the last one ragged)."""
    n = battery_points(img_hw)
    return 3 * sum(reveal_bound_s(min(chunk, n - s0), 3, img_hw, img_hw,
                                  batch) for s0 in range(0, n, chunk))


def busy_us(intervals) -> float:
    """Length of the union of [start, end) intervals (a frozen copy of
    the program's ``runners/profile_main_path.py _busy_us``)."""
    total, cur_start, cur_end = 0.0, None, None
    for start, end in sorted(intervals):
        if cur_end is None or start > cur_end:
            if cur_end is not None:
                total += cur_end - cur_start
            cur_start, cur_end = start, end
        else:
            cur_end = max(cur_end, end)
    if cur_end is not None:
        total += cur_end - cur_start
    return total


def forwards_per_image(traffic: dict, img_hw: int) -> int:
    """Forward-equivalents one scored image needs: the target forward,
    the attribution's (from the traffic file: IG-50 is 50 forwards and 50
    input gradients, each gradient counted as one more forward, with no
    weight gradient), and the battery's 3 passes."""
    return 1 + traffic["attribution_forwards"] + 3 * battery_points(img_hw)


def flops_per_image(macs_per_forward: int, traffic: dict,
                    img_hw: int) -> int:
    """FLOPs one scored image needs, 2 a multiply-accumulate."""
    return 2 * macs_per_forward * forwards_per_image(traffic, img_hw)


def least_s_per_image(macs_per_forward: int, traffic: dict, img_hw: int,
                      precision: str) -> float:
    """Least seconds one scored image needs at the card's peaks: the
    attribution's forward-equivalents at the peak of the traffic's
    ``attr_dtype``, the target forward and the battery's at the
    configuration's ``precision`` (a step that runs both precisions is
    held to each part's own peak)."""
    attr = traffic["attribution_forwards"]
    rest = forwards_per_image(traffic, img_hw) - attr
    flops = 2 * macs_per_forward
    return flops * (attr / peak_flops_per_s(
        traffic.get("attr_dtype", precision))
        + rest / peak_flops_per_s(precision))
