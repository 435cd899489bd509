"""Where one image's time goes on the card: one warm image of the
flagship path (the attribution, IG-50 or LIME with 1000 samples, then the
10-score battery), traced with ``torch.profiler``.

Run on a machine with a GPU:

    python -m xai_tpu_torch.runners.profile_main_path [--model R101] \
        [--attr_func {ig,lime}]

Prints the card, the wall seconds of the traced image, the share of that
wall time in which some kernel ran on the device, and the kernels by
total device time.  Needs CUDA: it never measures on the CPU.
"""
from __future__ import annotations

import argparse
import subprocess
import time
from collections import defaultdict

import numpy as np
import torch
from torch.autograd import DeviceType

from ..metrics.curves import run_battery
from ..registry import AttrContext, get_attribution
from .common import build_bundle, default_blur, normalize_input
from .evaluate_perturbation import image_generator


def _busy_us(intervals) -> float:
    """Length of the union of [start, end) intervals."""
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


def profile_image(model: str, device, attr_func: str = "ig",
                  top: int = 12) -> dict:
    bundle = build_bundle(model, device=device)
    hw = bundle.meta.img_hw
    img = np.random.RandomState(0).rand(hw, hw, 3).astype(np.float32)
    x = normalize_input(img, "cnn", device)
    blur = default_blur()

    def one_image():
        ctx = AttrContext(bundle=bundle, x=x, trans_img=img, target=1,
                          img_hw=hw, generator=image_generator(0, 0, device))
        sal = get_attribution("cnn", attr_func, ctx)
        run_battery(bundle.apply, x, sal, blur, chunk=45, target=1)
        torch.cuda.synchronize(device)

    one_image()                                  # warm-up: cuDNN plans
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        one_image()
        wall_s = time.perf_counter() - t0
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kernels:
        raise RuntimeError("the profiler recorded no device activity")
    by_name = defaultdict(lambda: [0, 0.0])
    for e in kernels:
        by_name[e.name][0] += 1
        by_name[e.name][1] += e.time_range.elapsed_us()
    busy = _busy_us((e.time_range.start, e.time_range.end) for e in kernels)
    span = (max(e.time_range.end for e in kernels)
            - min(e.time_range.start for e in kernels))
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][1])
    return {"wall_s": wall_s, "device_busy_us": busy,
            "device_span_us": span,
            "kernel_us_total": sum(v[1] for v in by_name.values()),
            "top": [{"name": n, "calls": c, "us": us}
                    for n, (c, us) in ranked[:top]]}


def main(argv=None):
    p = argparse.ArgumentParser("profile_main_path")
    p.add_argument("--model", default="R101")
    p.add_argument("--attr_func", default="ig", choices=["ig", "lime"])
    p.add_argument("--top", type=int, default=12)
    args = p.parse_args(argv)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    r = profile_image(args.model, torch.device("cuda"), args.attr_func,
                      args.top)
    what = {"ig": "IG-50", "lime": "LIME-1000"}[args.attr_func]
    print(f"card: {card}")
    print(f"{args.model}, one warm image ({what} + battery): wall "
          f"{r['wall_s']:.4f} s, device busy {r['device_busy_us'] / 1e6:.4f}"
          f" s ({100 * r['device_busy_us'] / 1e6 / r['wall_s']:.1f}% of "
          f"wall), kernel time summed {r['kernel_us_total'] / 1e6:.4f} s")
    for k in r["top"]:
        print(f"  {k['us'] / 1e3:10.3f} ms  {k['calls']:6d} calls  "
              f"{k['name'][:110]}")


if __name__ == "__main__":
    main()
