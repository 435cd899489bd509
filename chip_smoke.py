#!/usr/bin/env python3
"""Chip smoke run of xai_tpu_torch, the PyTorch / CUDA port, on one GPU.

Run from the root of the repository, on a machine with an NVIDIA H100 and
the CUDA toolkit:

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) on any error:

1. the card's name and power limit (nvidia-smi); float32 stays float32
   (TF32 off for cuDNN and cuBLAS);
2. build every kernel in xai_tpu_torch/csrc with nvcc, all at once;
3. hold each kernel against its plain PyTorch version on the card at the
   main path's shapes and at ragged ones (blur: max |delta| < 1e-5;
   reveal: bit-exact), and time kernel, plain version and one library
   call with CUDA events;
4. drive the main path through its entry point:
   evaluate_perturbation --model R101 --attr_func ig --synthetic 2 at
   224 px with seeded random weights, launch counters zeroed just before
   and read just after; the CSV must hold 10 finite scores, and each
   kernel must have launched (per scored image: blur >= 1, and reveal
   3 passes * ceil(225 / 45) chunks = 15);
5. check the answers against a reference on a small input: TINY_R at
   64 px, IG and the battery on the card against the same code on the CPU
   (where every kernel wrapper runs its plain version);
6. time one warm IG-50 attribution and one warm battery of R101.

Prints the card line, a {"kernels": [...]} JSON line, and last
{"ok": true, "device": {...}}.  Imports nothing of JAX or xai_tpu.
"""
from __future__ import annotations

import contextlib
import csv
import io
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

# published H100 SXM peaks (NVIDIA data sheet), for the bounds
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12

BLUR_TOL = 1e-5


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def device_ms(torch, fn, launches: int = 50, reps: int = 7) -> float:
    """Median device milliseconds per call of ``fn``.  A sleep kernel
    holds the stream while the host queues ``launches`` calls, so the
    events time the device back to back, not the host's launch rate."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(50_000_000)
        start.record()
        for _ in range(launches):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / launches)
    return statistics.median(times)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def check_kernels(torch, dev, x_hwc):
    """Phase 3: every kernel against its plain version, then timings."""
    import numpy as np
    import torch.nn.functional as F

    from xai_tpu_torch.kernels import blur as kblur
    from xai_tpu_torch.kernels import reveal as kreveal
    from xai_tpu_torch.metrics.curves import pixel_flip_steps
    from xai_tpu_torch.ops.blur import gkern

    rows = []
    # --- blur: [3, 224, 224] (the main path) and a ragged 200 x 131 ---
    planes = x_hwc.permute(2, 0, 1).contiguous()
    ragged = torch.randn(3, 200, 131, device=dev,
                         generator=torch.Generator(dev).manual_seed(1))
    err = 0.0
    for t in (planes, ragged):
        got = kblur.blur_planes(t)
        want = kblur.blur_planes_plain(t)
        torch.cuda.synchronize()
        err = max(err, float((got - want).abs().max()))
        if not bool(torch.isfinite(got).all()):
            fail("blur kernel produced non-finite values")
    print(f"blur_planes: max |kernel - plain| = {err:.3g} "
          f"(tolerance {BLUR_TOL})")
    if not err < BLUR_TOL:
        fail(f"blur kernel disagrees with its plain version: {err}")
    weight = torch.as_tensor(gkern(31, 31.0), device=dev).expand(
        3, 1, 31, 31).contiguous()
    n, h, w = planes.shape
    klen = 31
    rows.append(dict(
        name="blur_planes", route="cuda",
        source="xai_tpu_torch/csrc/blur.cu",
        replaces="xai_tpu/kernels/blur_pallas.py:88",
        max_abs_err=err,
        ms=device_ms(torch, lambda: kblur.blur_planes(planes)),
        plain_ms=device_ms(torch, lambda: kblur.blur_planes_plain(planes)),
        library_ms=device_ms(torch, lambda: F.conv2d(
            planes[None], weight, padding=15, groups=3)),
        # one read and one write of the planes, 2 passes x klen FMAs/px
        bound_ms=max(2 * n * h * w * 4 / HBM_BYTES_PER_S,
                     n * h * w * 2 * klen * 2 / F32_FLOPS_PER_S) * 1e3,
        bound_by="bytes" if 2 * n * h * w * 4 / HBM_BYTES_PER_S
        >= n * h * w * 2 * klen * 2 / F32_FLOPS_PER_S else "operations"))

    # --- reveal: S=45 at 224 px (the main path), ragged S=1, and a plane
    # size that is not a multiple of 4 (the scalar variant) ---
    rs = np.random.RandomState(0)
    finish = kblur.blur_planes(planes)
    flip = torch.from_numpy(pixel_flip_steps(rs.rand(224, 224), 224)
                            .reshape(224, 224)).to(dev)
    steps45 = torch.arange(0, 45, dtype=torch.int32, device=dev)
    small = torch.rand(3, 15, 13, device=dev)
    small_flip = torch.from_numpy(pixel_flip_steps(rs.rand(15, 13), 15)
                                  .reshape(15, 13)).to(dev)
    cases = [(planes, finish, flip, steps45),
             (planes, torch.zeros_like(planes), flip,
              torch.tensor([225], dtype=torch.int32, device=dev)),
             (small, torch.zeros_like(small), small_flip,
              torch.tensor([0, 5, 14], dtype=torch.int32, device=dev))]
    for case in cases:
        got = kreveal.reveal_chunk(*case)
        want = kreveal.reveal_chunk_plain(*case)
        torch.cuda.synchronize()
        if got.shape != want.shape or not torch.equal(got, want):
            fail(f"reveal kernel disagrees with its plain version at "
                 f"{tuple(want.shape)}")
    print("reveal_chunk: bit-exact against the plain version "
          "(S=45 and S=1 at 224 px, 3x15x13)")
    s, (c, h, w) = steps45.shape[0], planes.shape
    # each input read once, the [S, C, H, W] batch written once
    rbytes = (s * c * h * w + 2 * c * h * w) * 4 + (h * w + s) * 4
    rows.append(dict(
        name="reveal_chunk", route="cuda",
        source="xai_tpu_torch/csrc/reveal.cu",
        replaces="xai_tpu/kernels/reveal.py:30",
        max_abs_err=0.0,
        ms=device_ms(torch, lambda: kreveal.reveal_chunk(
            planes, finish, flip, steps45)),
        plain_ms=device_ms(torch, lambda: kreveal.reveal_chunk_plain(
            planes, finish, flip, steps45)),
        library_ms=device_ms(torch, lambda: torch.where(
            flip[None, None] <= steps45[:, None, None, None], finish,
            planes)),
        bound_ms=rbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes"))
    return rows


def run_main_path(torch, dev, out_dir):
    """Phase 4: the flagship driver on R101, counters zeroed around it."""
    from xai_tpu_torch.kernels.blur import blur_planes
    from xai_tpu_torch.kernels.reveal import reveal_chunk
    from xai_tpu_torch.runners import evaluate_perturbation as ep

    n_images = 2
    args = ep.build_parser().parse_args(
        ["--model", "R101", "--attr_func", "ig", "--synthetic",
         str(n_images), "--image_count", str(n_images), "--output_dir",
         out_dir, "--verbose"])
    torch.cuda.reset_peak_memory_stats(dev)
    log = io.StringIO()
    blur_planes.launches = 0
    reveal_chunk.launches = 0
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(log):
        ep.evaluate_perturbation(args, device=dev)
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    launches = {"blur_planes": blur_planes.launches,
                "reveal_chunk": reveal_chunk.launches}
    peak = torch.cuda.max_memory_allocated(dev)
    print(log.getvalue(), end="")
    # --verbose prints one line per scored image.  The class quota
    # (ceil(image_count / 1000) images per predicted class) can skip an
    # image: two noise images usually get the same top-1 class.
    scored = sum(line.startswith("[") for line in log.getvalue().splitlines())
    if scored < 1:
        fail("the main path scored no image")

    with open(os.path.join(out_dir, "R101", f"ig_{n_images}_images.csv")) as f:
        rows = {r[0]: float(r[1]) for r in csv.reader(f) if r}
    scores = {k: v for k, v in rows.items()
              if k not in ("Attr Avg Runtime", "Total Runtime")}
    print("main path scores:", json.dumps(scores))
    if len(scores) != 10 or not all(math.isfinite(v) for v in
                                    scores.values()):
        fail(f"expected 10 finite scores, got {scores}")
    # per scored image: one blur (the battery's substrate; the synthetic
    # stream skips the gates) and 3 passes of ceil(225 / 45) = 5 reveal
    # chunks: 224 steps of 224 pixels, plus step 0
    per_pass = math.ceil((224 * 224 // 224 + 1) / 45)
    if launches["blur_planes"] < scored:
        fail(f"blur kernel launched {launches['blur_planes']} times on the "
             f"main path, expected >= {scored}")
    if launches["reveal_chunk"] != 3 * per_pass * scored:
        fail(f"reveal kernel launched {launches['reveal_chunk']} times on "
             f"the main path, expected {3 * per_pass * scored}")
    print(f"main path: {scored} of {n_images} images scored, total "
          f"{total:.3f} s, attribution {rows['Attr Avg Runtime']:.3f} "
          f"s/image (driver CSV, first image cold), peak memory "
          f"{peak / 2**30:.2f} GiB, launches {json.dumps(launches)}")
    return launches


def check_small_reference(torch, dev):
    """Phase 5: TINY_R on the card against the same code on the CPU."""
    import numpy as np

    from xai_tpu_torch.metrics.curves import run_battery
    from xai_tpu_torch.registry import AttrContext, get_attribution
    from xai_tpu_torch.runners.common import (build_bundle, default_blur,
                                              normalize_input)

    img = np.random.RandomState(5).rand(64, 64, 3).astype(np.float32)
    results = {}
    for name, d in (("cuda", dev), ("cpu", torch.device("cpu"))):
        bundle = build_bundle("TINY_R", seed=1, device=d)
        x = normalize_input(img, "cnn", d)
        target = int(bundle.apply(x.permute(2, 0, 1)[None]).argmax())
        sal = get_attribution("cnn", "ig", AttrContext(
            bundle=bundle, x=x, trans_img=img, target=target, img_hw=64))
        results[name] = (target, sal, bundle, x)
    (t_gpu, s_gpu, b_gpu, x_gpu), (t_cpu, s_cpu, b_cpu, x_cpu) = (
        results["cuda"], results["cpu"])
    if t_gpu != t_cpu:
        fail(f"TINY_R argmax differs: cuda {t_gpu}, cpu {t_cpu}")
    sal_err = float(np.abs(s_gpu - s_cpu).max() / np.abs(s_cpu).max())
    # float32 (no TF32) convolutions in cuDNN vs oneDNN sum in different
    # orders: ~1e-6 relative, here allowed 1e-4
    if not sal_err < 1e-4:
        fail(f"IG saliency on the card differs from the CPU: {sal_err}")
    sg = run_battery(b_gpu.apply, x_gpu, s_cpu, default_blur(),
                     target=t_cpu)
    sc = run_battery(b_cpu.apply, x_cpu, s_cpu, default_blur(),
                     target=t_cpu)
    worst = max(abs(sg[k] - sc[k]) for k in sc)
    if not all(math.isfinite(v) for v in sg.values()) or not worst < 2e-3:
        fail(f"battery on the card differs from the CPU: {sg} vs {sc}")
    print(f"TINY_R 64 px, card vs CPU: IG saliency rel err {sal_err:.3g} "
          f"(< 1e-4), battery max |score delta| {worst:.3g} (< 2e-3)")


def time_warm_image(torch, dev):
    """Phase 6: one warm IG-50 and one warm battery of R101, seconds."""
    import numpy as np

    from xai_tpu_torch.metrics.curves import run_battery
    from xai_tpu_torch.registry import AttrContext, get_attribution
    from xai_tpu_torch.runners.common import (build_bundle, default_blur,
                                              normalize_input)

    bundle = build_bundle("R101", device=dev)
    img = np.random.RandomState(0).rand(224, 224, 3).astype(np.float32)
    x = normalize_input(img, "cnn", dev)
    ctx = AttrContext(bundle=bundle, x=x, trans_img=img, target=1)
    blur = default_blur()
    times = {"attr": [], "battery": []}
    for _ in range(2):                       # the first round warms up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sal = get_attribution("cnn", "ig", ctx)
        t1 = time.perf_counter()
        run_battery(bundle.apply, x, sal, blur, chunk=45, target=1)
        torch.cuda.synchronize()
        times["attr"].append(t1 - t0)
        times["battery"].append(time.perf_counter() - t1)
    print(f"R101 warm: IG-50 attribution {times['attr'][-1]:.4f} s/image, "
          f"battery {times['battery'][-1]:.4f} s/image "
          f"(cold: {times['attr'][0]:.4f}, {times['battery'][0]:.4f})")


def main() -> None:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this run needs a GPU")
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    import xai_tpu_torch
    if not os.path.abspath(xai_tpu_torch.__file__).startswith(here + os.sep):
        fail(f"xai_tpu_torch imported from {xai_tpu_torch.__file__}, not "
             f"from this checkout")
    from xai_tpu_torch.kernels import _build
    from xai_tpu_torch.ops.preprocess import normalize, IMAGENET_MEAN, \
        IMAGENET_STD
    from xai_tpu_torch.runners.common import resolve_device

    card = card_line()
    print(card)                     # as nvidia-smi prints it
    dev = resolve_device("cuda:0")          # also turns TF32 off
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    report = _build.build()
    print(f"kernel build: {time.perf_counter() - t0:.2f} s for "
          f"{sorted(report) or 'nothing (already built)'}")
    for name, r in report.items():
        for line in r["log"].splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    img = np.random.RandomState(0).rand(224, 224, 3)
    x_hwc = normalize(torch.as_tensor(img, dtype=torch.float32, device=dev),
                      IMAGENET_MEAN, IMAGENET_STD)
    rows = check_kernels(torch, dev, x_hwc)

    with tempfile.TemporaryDirectory() as out_dir:
        launches = run_main_path(torch, dev, out_dir)
    check_small_reference(torch, dev)
    time_warm_image(torch, dev)

    for row in rows:
        row["launches"] = launches[row["name"]]
        row["kernel_ms"] = row["ms"]
        print(f"{row['name']}: kernel {row['ms'] * 1e3:.2f} us, plain "
              f"{row['plain_ms'] * 1e3:.2f} us, library "
              f"{row['library_ms'] * 1e3:.2f} us, bound "
              f"{row['bound_ms'] * 1e3:.3f} us ({row['bound_by']}) on {card}")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
