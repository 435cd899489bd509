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
   main paths' shapes and at ragged ones, heights and widths that are not
   multiples of the kernels' tiles among them (blur: max |delta| < 1e-5;
   reveal and quickshift parents: bit-exact, quickshift densities max
   |delta| 0), and time kernel, plain version and, where one exists, one
   library call with CUDA events, beside the card's per-launch floor (an
   empty torch.cuda._sleep(0)) and each kernel's bound
   (xai_tpu_torch/kernels/bounds.py); the quickshift cases cover both of
   its tiles at ragged heights, and w=18 on both; time its two phases
   with torch.profiler;
   the batched reveal (reveal_batch) is checked bit-exact at
   [4, 45, 3, 224, 224], at a ragged B=3, S=7 on 3x15x13 (the scalar
   variant) and at B=1 against reveal_chunk, and timed at B=4 beside
   torch.where over the batch and its bound;
4. drive the main paths through their entry point,
   evaluate_perturbation --model R101 at 224 px with seeded random
   weights, launch counters zeroed just before each and read just after:
   --synthetic 2 with --attr_func ig, then lime (image by image); then
   --image_batch 4 --synthetic 4 --image_count 4000 with ig in f32 and in
   bf16, and --attr_func lime --image_batch 2 --synthetic 2 --image_count
   2000 --attr_dtype bf16 (the quota of ceil(image_count / 1000) images a
   class keeps every noise image, which random weights give one class).
   Each CSV must hold 10 finite scores; each battery (a scored image, or a
   flush of a batch) must launch blur once (>= once image by image),
   reveal 3 passes * ceil(225 / 45) chunks = 15 times, and quickshift
   once on a LIME path; a batched path must score all its images in full
   batches;
5. check the answers against a reference on a small input: TINY_R at
   64 px on the card against the same code on the CPU (where every kernel
   wrapper runs its plain version): IG and the battery, and LIME with
   injected sample rows; at B=3 and 32 px (inputs that meet no ReLU kink
   within float32 rounding), batch_attribution of ig, lig, idg, idgi,
   grad and inp_x_grad, and sg_batch with injected noise, within 1e-4
   relative in float32, and the batched battery within 2e-3; bf16 ig
   against float32 on the card, Spearman rho > 0.98 on the tiny CNN of
   xai_tpu's bf16 contract;
6. time one warm IG-50 attribution, one warm battery and one warm LIME
   attribution of R101, LIME split by stage with CUDA events; then R101 at
   B=4: batched IG-50, LIG, IDG, IDGI and SG in float32 and in bf16, and
   the batched battery, per image, with CUDA events.

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

BLUR_TOL = 1e-5
# TINY_R LIME, card vs CPU: float32 forwards in cuDNN and oneDNN sum in
# other orders (~1e-6 relative in the probabilities); coefficients within
# 1e-4 of the largest, the tolerance of tests/test_torch_lime.py
LIME_COEF_TOL = 1e-4


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def device_ms(torch, fn, launches: int = 50, reps: int = 7) -> float:
    """Median device milliseconds per call of ``fn``.  A sleep kernel
    holds the stream while the host queues ``launches`` calls, so the
    events time the device back to back, not the host's launch rate (as
    long as the calls' launches fit in the launch queue)."""
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


def phase_us(torch, fn, calls: int = 100) -> dict:
    """Device microseconds per call of ``fn``'s kernels, summed by phase
    (a kernel whose name holds "density" or "parent"), with
    torch.profiler over ``calls`` warm calls."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {"density": 0.0, "parent": 0.0}
    for e in prof.key_averages():
        for phase in out:
            if phase in e.key:
                out[phase] += e.device_time_total / calls
    return out


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def kernel_wrappers() -> dict:
    """Every kernel wrapper by name; each counts its launches."""
    from xai_tpu_torch.kernels.blur import blur_planes
    from xai_tpu_torch.kernels.quickshift import quickshift_parents
    from xai_tpu_torch.kernels.reveal import reveal_batch
    return {"blur_planes": blur_planes, "reveal_batch": reveal_batch,
            "quickshift_parents": quickshift_parents}


def check_kernels(torch, dev, x_hwc):
    """Phase 3, blur and reveal: each against its plain version, then
    timings."""
    import numpy as np
    import torch.nn.functional as F

    from xai_tpu_torch.kernels import blur as kblur
    from xai_tpu_torch.kernels import reveal as kreveal
    from xai_tpu_torch.kernels.bounds import blur_bound_ms, reveal_bound_ms
    from xai_tpu_torch.metrics.curves import pixel_flip_steps
    from xai_tpu_torch.ops.blur import gkern

    rows = []
    # --- blur: [3, 224, 224] (the main path), [12, 224, 224] (four images
    # at once), and ragged planes whose heights and widths are not
    # multiples of the kernel's 32 x 40 tile; klen 11 runs another
    # instantiation ---
    planes = x_hwc.permute(2, 0, 1).contiguous()
    gen = torch.Generator(dev).manual_seed(1)
    planes12 = torch.randn(12, 224, 224, device=dev, generator=gen)
    cases = [(planes, 31, 31.0), (planes12, 31, 31.0),
             (torch.randn(3, 200, 131, device=dev, generator=gen), 31, 31.0),
             (torch.randn(2, 203, 97, device=dev, generator=gen), 31, 31.0),
             (torch.randn(1, 57, 45, device=dev, generator=gen), 11, 5.0)]
    err = 0.0
    for t, klen, nsig in cases:
        got = kblur.blur_planes(t, klen, nsig)
        want = kblur.blur_planes_plain(t, klen, nsig)
        torch.cuda.synchronize()
        err = max(err, float((got - want).abs().max()))
        if not bool(torch.isfinite(got).all()):
            fail("blur kernel produced non-finite values")
    print(f"blur_planes: max |kernel - plain| = {err:.3g} "
          f"(tolerance {BLUR_TOL}) over "
          + ", ".join(f"{list(t.shape)} klen {k}" for t, k, _ in cases))
    if not err < BLUR_TOL:
        fail(f"blur kernel disagrees with its plain version: {err}")
    weight = torch.as_tensor(gkern(31, 31.0), device=dev).expand(
        3, 1, 31, 31).contiguous()
    n, h, w = planes.shape
    bound_ms, bound_by = blur_bound_ms(n, h, w, 31)
    floor_ms = device_ms(torch, lambda: torch.cuda._sleep(0))
    rows.append(dict(
        name="blur_planes", route="cuda",
        source="xai_tpu_torch/csrc/blur.cu",
        replaces="xai_tpu/kernels/blur_pallas.py:88",
        max_abs_err=err,
        ms=device_ms(torch, lambda: kblur.blur_planes(planes)),
        plain_ms=device_ms(torch, lambda: kblur.blur_planes_plain(planes)),
        library_ms=device_ms(torch, lambda: F.conv2d(
            planes[None], weight, padding=15, groups=3)),
        bound_ms=bound_ms, bound_by=bound_by,
        ms_n12=device_ms(torch, lambda: kblur.blur_planes(planes12)),
        bound_ms_n12=blur_bound_ms(12, h, w, 31)[0],
        launch_floor_ms=floor_ms))
    print(f"per-launch floor (torch.cuda._sleep(0)): {floor_ms * 1e3:.2f} "
          f"us; blur [12, 224, 224]: {rows[-1]['ms_n12'] * 1e3:.2f} us")

    # --- reveal: one image (reveal_chunk, the B = 1 view): S=45 at 224 px
    # (the per-image path), ragged S=1, and a plane size that is not a
    # multiple of 4 (the scalar variant); a batch (reveal_batch):
    # [4, 45, 3, 224, 224] (the batched path at --image_batch 4), a ragged
    # B=3, S=7 at 3x15x13 (scalar), and B=1 against reveal_chunk ---
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
        want = kreveal.reveal_batch_plain(*(t[None] for t in case[:3]),
                                          case[3])[0]
        torch.cuda.synchronize()
        if got.shape != want.shape or not torch.equal(got, want):
            fail(f"reveal kernel disagrees with its plain version at "
                 f"{tuple(want.shape)}")

    def flips(b, h, w):
        return torch.from_numpy(np.stack([
            pixel_flip_steps(rs.rand(h, w), h).reshape(h, w)
            for _ in range(b)])).to(dev)

    starts4 = torch.randn(4, 3, 224, 224, device=dev, generator=gen)
    finishes4 = kblur.blur_planes(starts4.view(12, 224, 224)).view(
        4, 3, 224, 224)
    flips4 = flips(4, 224, 224)
    batch_cases = [
        (starts4, finishes4, flips4, steps45),
        (torch.rand(3, 3, 15, 13, device=dev),
         torch.zeros(3, 3, 15, 13, device=dev), flips(3, 15, 13),
         torch.tensor([0, 2, 3, 5, 8, 13, 15], dtype=torch.int32,
                      device=dev))]
    for case in batch_cases:
        got = kreveal.reveal_batch(*case)
        want = kreveal.reveal_batch_plain(*case)
        torch.cuda.synchronize()
        if got.shape != want.shape or not torch.equal(got, want):
            fail(f"reveal kernel disagrees with its plain version at "
                 f"{tuple(want.shape)}")
    one = kreveal.reveal_batch(planes[None], finish[None], flip[None],
                               steps45)
    if not torch.equal(one[0], kreveal.reveal_chunk(planes, finish, flip,
                                                    steps45)):
        fail("reveal_batch at B=1 differs from reveal_chunk")
    print("reveal_batch: bit-exact against the plain version (one image: "
          "S=45 and S=1 at 224 px, 3x15x13; batches: [4, 45, 3, 224, 224], "
          "B=3 S=7 at 3x15x13; B=1 equal to reveal_chunk)")
    s, (c, h, w) = steps45.shape[0], planes.shape
    rows.append(dict(
        name="reveal_batch", route="cuda",
        source="xai_tpu_torch/csrc/reveal.cu",
        replaces="xai_tpu/kernels/reveal.py:30",
        max_abs_err=0.0,
        ms=device_ms(torch, lambda: kreveal.reveal_chunk(
            planes, finish, flip, steps45)),
        plain_ms=device_ms(torch, lambda: kreveal.reveal_batch_plain(
            planes[None], finish[None], flip[None], steps45)),
        library_ms=device_ms(torch, lambda: torch.where(
            flip[None, None] <= steps45[:, None, None, None], finish,
            planes)),
        bound_ms=reveal_bound_ms(s, c, h, w), bound_by="bytes",
        ms_b4=device_ms(torch, lambda: kreveal.reveal_batch(
            starts4, finishes4, flips4, steps45)),
        plain_ms_b4=device_ms(torch, lambda: kreveal.reveal_batch_plain(
            starts4, finishes4, flips4, steps45)),
        bound_ms_b4=reveal_bound_ms(s, c, h, w, b=4)))
    print(f"reveal_batch [4, 45, 3, 224, 224]: kernel "
          f"{rows[-1]['ms_b4'] * 1e3:.2f} us, torch.where over the batch "
          f"{rows[-1]['plain_ms_b4'] * 1e3:.2f} us, bound "
          f"{rows[-1]['bound_ms_b4'] * 1e3:.2f} us (bytes)")
    return rows


def quickshift_tile_rows(b, h, w_img, sms):
    """The height of the 32-wide output tile that csrc/quickshift.cu
    launch_tile picks: 16 where that tile's blocks spread over the SMs
    with the busiest at most 10/9 of the mean, else 4."""
    blocks = -(-w_img // 32) * -(-h // 16) * b
    busiest = -(-blocks // sms)
    return 16 if blocks * 10 >= busiest * sms * 9 else 4


def check_quickshift(torch, dev):
    """Phase 3, quickshift: parents bit-exact and densities equal against
    the plain version, then timings."""
    import numpy as np

    from xai_tpu_torch.kernels import quickshift as kq
    from xai_tpu_torch.kernels.bounds import (F32_LANE_OPS_PER_S,
                                              quickshift_bound_ms,
                                              quickshift_exp_ms)
    from xai_tpu_torch.ops import quickshift as oq

    w, wd, inv2s2, max_d2 = oq.quickshift_params(4.0, 200.0)   # LIME's
    rs = np.random.RandomState(3)

    def gradient(h, w_img):
        yy, xx = np.mgrid[0:h, 0:w_img]
        img = np.stack([yy / h, xx / w_img, yy * xx / (h * w_img)], -1)
        return np.clip(img + 0.05 * rs.rand(h, w_img, 3), 0, 1)

    # heights 227, 97 and 61 are not multiples of the tile heights 4 and
    # 16, nor widths 131, 80 and 75 of the tile width 32: ragged strips
    # and columns at the bottom and right edges, on both tiles; w=18 on
    # the 32x16 tile needs more than 48 KB of shared memory
    cases = [
        ("4x224x224: 2 noise, 2 gradient + jitter",
         np.stack([rs.rand(224, 224, 3), rs.rand(224, 224, 3),
                   gradient(224, 224), gradient(224, 224)]), w, wd),
        ("1x200x131 noise", rs.rand(1, 200, 131, 3), w, wd),
        ("1x227x131 noise", rs.rand(1, 227, 131, 3), w, wd),
        ("2x227x131 gradient + jitter",
         np.stack([gradient(227, 131), gradient(227, 131)]), w, wd),
        ("8x227x131: 4 noise, 4 gradient + jitter",
         np.stack([rs.rand(227, 131, 3) for _ in range(4)]
                  + [gradient(227, 131) for _ in range(4)]), w, wd),
        ("2x64x80 noise, w=6 wd=4", rs.rand(2, 64, 80, 3), 6, 4),
        ("2x97x80: noise, gradient + jitter, w=6 wd=4",
         np.stack([rs.rand(97, 80, 3), gradient(97, 80)]), 6, 4),
        ("1x61x75 gradient + jitter, w=18 wd=18 (MAX_W)",
         gradient(61, 75)[None], kq.MAX_W, kq.MAX_W),
        ("10x61x75: 5 noise, 5 gradient + jitter, w=18 wd=18 (MAX_W)",
         np.stack([rs.rand(61, 75, 3) for _ in range(5)]
                  + [gradient(61, 75) for _ in range(5)]), kq.MAX_W,
         kq.MAX_W),
    ]
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    tile_rows = [quickshift_tile_rows(*x.shape[:3], sms) for _, x, _, _ in
                 cases]
    covered = {(ty, cw) for ty, (_, x, cw, _) in zip(tile_rows, cases)
               if x.shape[1] % ty}
    for ty in (4, 16):
        if not {(ty, w), (ty, kq.MAX_W)} <= covered:
            fail(f"no quickshift case of a ragged height takes the 32x{ty} "
                 f"tile at both w={w} and w={kq.MAX_W} on {sms} SMs")
    dens_err = 0.0
    for (label, x, cw, cwd), ty in zip(cases, tile_rows):
        rgbs = torch.as_tensor(x, dtype=torch.float32, device=dev)
        lab = oq.lab_planes(rgbs, 0.2)
        want, want_d = oq.parents_density_plain(lab, cw, cwd, inv2s2,
                                                max_d2)
        got, got_d = kq.parents_density(lab, cw, cwd, inv2s2, max_d2)
        wrapper = kq.quickshift_parents(rgbs, inv2s2, max_d2, 0.2, w=cw,
                                        wd=cwd)
        torch.cuda.synchronize()
        err = float((got_d - want_d).abs().max())
        dens_err = max(dens_err, err)
        if not (torch.equal(got, want) and torch.equal(wrapper, want)):
            fail(f"quickshift kernel parents differ from the plain "
                 f"version on {label}: "
                 f"{int((got != want).sum())} pixels")
        if err != 0.0:
            fail(f"quickshift kernel densities differ from the plain "
                 f"version on {label}: max |delta| {err}")
        print(f"quickshift_parents {label} (32x{ty} tile): parents "
              f"bit-exact, density max |kernel - plain| = {err:.3g}")

    lab4 = oq.lab_planes(torch.as_tensor(cases[0][1], dtype=torch.float32,
                                         device=dev), 0.2)
    lab1 = lab4[:1].contiguous()
    bound_ms, ops = quickshift_bound_ms(1, 224, 224, w, wd)
    row = dict(
        name="quickshift_parents", route="cuda",
        source="xai_tpu_torch/csrc/quickshift.cu",
        replaces="xai_tpu/kernels/quickshift_pallas.py:119",
        max_abs_err=0.0, density_max_abs_err=dens_err,
        ms=device_ms(torch, lambda: kq.parents_density(
            lab1, w, wd, inv2s2, max_d2)),
        ms_b4=device_ms(torch, lambda: kq.parents_density(
            lab4, w, wd, inv2s2, max_d2)),
        # ~18 k small launches per call overflow the launch queue, so
        # this is the host's launch rate, not device time
        plain_ms=device_ms(torch, lambda: oq.parents_density_plain(
            lab1, w, wd, inv2s2, max_d2), launches=2, reps=3),
        library_ms=None,          # no PyTorch call computes quickshift
        bound_ms=bound_ms, bound_by="operations", lane_ops=ops,
        bound_ms_b4=quickshift_bound_ms(4, 224, 224, w, wd)[0],
        exp_ms=quickshift_exp_ms(1, 224, 224, w),
        phases_us={f"B={lab.shape[0]}": phase_us(torch, lambda: (
            kq.parents_density(lab, w, wd, inv2s2, max_d2)))
            for lab in (lab1, lab4)})
    print(f"quickshift_parents: {ops / 1e6:.1f} M FP32 lane operations per "
          f"224 px image over {F32_LANE_OPS_PER_S / 1e12:.1f} T/s; exps "
          f"alone {row['exp_ms'] * 1e3:.2f} us on the special-function "
          f"units; kernel B=1 {row['ms'] * 1e3:.2f} us, B=4 "
          f"{row['ms_b4'] * 1e3:.2f} us; by phase (profiler) "
          + ", ".join(f"{b}: density {p['density']:.2f} us, parent "
                      f"{p['parent']:.2f} us"
                      for b, p in row["phases_us"].items()))
    return row


# the driver paths of phase 4: (label, flags, images in the stream,
# --image_count, --image_batch).  Random weights usually give noise images
# one class, so a batched path's --image_count is 1000x its images: the
# class quota (ceil(image_count / 1000) a class) then keeps them all, the
# batch fills, and the stream ends at --synthetic.
MAIN_PATHS = [
    ("ig", ["--attr_func", "ig"], 2, 2, 1),
    ("lime", ["--attr_func", "lime"], 2, 2, 1),
    ("ig_b4", ["--attr_func", "ig"], 4, 4000, 4),
    ("ig_b4_bf16", ["--attr_func", "ig", "--attr_dtype", "bf16"], 4, 4000,
     4),
    ("lime_b2_bf16", ["--attr_func", "lime", "--attr_dtype", "bf16"], 2,
     2000, 2),
]
# 3 passes of ceil(225 / 45) = 5 reveal chunks at 224 px: 224 steps of 224
# pixels, plus step 0
REVEAL_PER_BATTERY = 3 * math.ceil((224 * 224 // 224 + 1) / 45)


def run_main_path(torch, dev, out_dir, label, flags, n_images, count,
                  batch):
    """Phase 4: the flagship driver on R101, counters zeroed just before
    and read just after.  A per-image path scores image by image (the
    class quota may skip the second); a batched path must score all its
    images in full batches."""
    from xai_tpu_torch.runners import evaluate_perturbation as ep

    out_dir = os.path.join(out_dir, label)
    attr_func = flags[flags.index("--attr_func") + 1]
    args = ep.build_parser().parse_args(
        ["--model", "R101", *flags, "--synthetic", str(n_images),
         "--image_count", str(count), "--image_batch", str(batch),
         "--output_dir", out_dir, "--verbose"])
    torch.cuda.reset_peak_memory_stats(dev)
    log = io.StringIO()
    wrappers = kernel_wrappers()
    for fn in wrappers.values():
        fn.launches = 0
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(log):
        ep.evaluate_perturbation(args, device=dev)
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in wrappers.items()}
    peak = torch.cuda.max_memory_allocated(dev)
    print(log.getvalue(), end="")
    # --verbose prints one line per scored image ("[i/n] ..." image by
    # image, "[batch] ..." in a batch)
    scored = sum(line.startswith("[") for line in log.getvalue().splitlines())
    if scored < 1 or (batch > 1 and scored != n_images):
        fail(f"the {label} main path scored {scored} of {n_images} images")

    with open(os.path.join(out_dir, "R101",
                           f"{attr_func}_{count}_images.csv")) as f:
        rows = {r[0]: float(r[1]) for r in csv.reader(f) if r}
    scores = {k: v for k, v in rows.items()
              if k not in ("Attr Avg Runtime", "Total Runtime")}
    print(f"{label} main path scores:", json.dumps(scores))
    if len(scores) != 10 or not all(math.isfinite(v) for v in
                                    scores.values()):
        fail(f"expected 10 finite scores, got {scores}")
    # per battery (one scored image, or one flush of a batch): one blur
    # launch over all its planes (the synthetic stream skips the gates,
    # which blur too) and 15 reveal launches; LIME segments its image(s)
    # in one quickshift launch
    flushes = scored // batch
    if batch == 1:
        ok_blur = launches["blur_planes"] >= scored
    else:
        ok_blur = launches["blur_planes"] == flushes
    want_reveal = REVEAL_PER_BATTERY * flushes
    want_qs = flushes if attr_func == "lime" else 0
    if not ok_blur:
        fail(f"blur kernel launched {launches['blur_planes']} times on the "
             f"{label} main path ({flushes} batteries)")
    if launches["reveal_batch"] != want_reveal:
        fail(f"reveal kernel launched {launches['reveal_batch']} times on "
             f"the {label} main path, expected {want_reveal}")
    if launches["quickshift_parents"] != want_qs:
        fail(f"quickshift kernel launched "
             f"{launches['quickshift_parents']} times on the {label} "
             f"main path, expected {want_qs}")
    print(f"{label} main path: {scored} of {n_images} images scored in "
          f"{flushes} {'flushes of ' + str(batch) if batch > 1 else 'runs'}"
          f", total {total:.3f} s, attribution "
          f"{rows['Attr Avg Runtime']:.3f} s/image (driver CSV, first "
          f"batch cold), peak memory {peak / 2**30:.2f} GiB, launches "
          f"{json.dumps(launches)}")
    return launches


def check_small_reference(torch, dev):
    """Phase 5: TINY_R on the card against the same code on the CPU."""
    import numpy as np

    from xai_tpu_torch.methods import lime as tl
    from xai_tpu_torch.metrics.curves import run_battery
    from xai_tpu_torch.registry import AttrContext, get_attribution
    from xai_tpu_torch.runners.common import (build_bundle, default_blur,
                                              normalize_input)

    img = np.random.RandomState(5).rand(64, 64, 3).astype(np.float32)
    # LIME sample rows: random bits over the image's segments (as the CPU
    # finds them), row 0 all-on; both devices get the same rows
    _, count = tl.lime_segments(img, device="cpu")
    rows = np.random.RandomState(9).randint(0, 2, (200, count)).astype(
        np.int8)
    rows[0] = 1
    results = {}
    for name, d in (("cuda", dev), ("cpu", torch.device("cpu"))):
        bundle = build_bundle("TINY_R", seed=1, device=d)
        x = normalize_input(img, "cnn", d)
        target = int(bundle.apply(x.permute(2, 0, 1)[None]).argmax())
        sal = get_attribution("cnn", "ig", AttrContext(
            bundle=bundle, x=x, trans_img=img, target=target, img_hw=64))
        lime = tl.lime_batch(bundle, img[None], None, chunk=50,
                             rows=rows[None], return_coef=True, device=d)
        labels = tl.lime_segments(img, device=d)[0]
        results[name] = (target, sal, bundle, x, lime, labels)
    (t_gpu, s_gpu, b_gpu, x_gpu, l_gpu, lab_gpu), \
        (t_cpu, s_cpu, b_cpu, x_cpu, l_cpu, lab_cpu) = (
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

    (m_gpu, c_gpu), (m_cpu, c_cpu) = l_gpu, l_cpu
    if not np.array_equal(lab_gpu, lab_cpu):
        fail("LIME segments on the card (quickshift kernel) differ from "
             "the CPU's (plain version)")
    coef_err = float(np.abs(c_gpu - c_cpu).max() / np.abs(c_cpu).max())
    if not np.array_equal(m_gpu, m_cpu) or not coef_err < LIME_COEF_TOL:
        fail(f"LIME on the card differs from the CPU: masks equal "
             f"{np.array_equal(m_gpu, m_cpu)}, coef rel err {coef_err}")
    print(f"TINY_R 64 px LIME (200 injected rows, {int(lab_cpu.max()) + 1} "
          f"segments), card vs CPU: segments and mask equal "
          f"({int(m_cpu.sum())} pixels on), coef rel err {coef_err:.3g} "
          f"(< {LIME_COEF_TOL})")


def time_warm_image(torch, dev, card):
    """Phase 6: one warm IG-50, one warm battery and one warm LIME of
    R101; LIME split into its stages with CUDA events."""
    import numpy as np

    from xai_tpu_torch.methods import lime as tl
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
    per_image = {"ig": times["attr"][-1], "battery": times["battery"][-1]}

    # LIME as lime() runs it: B=1, 1000 samples, chunk 100, stage by stage
    imgs = torch.as_tensor(img, device=dev)[None]
    stages = ("segment", "sample rows", "sweep", "ridge + selection")
    for rnd in range(2):                     # the first round warms up
        gen = torch.Generator(dev).manual_seed(rnd)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ev[0].record()
        labels, counts = tl.segment(imgs)
        ev[1].record()
        rows = tl.sample_rows([gen], counts, 1000)
        ev[2].record()
        probs = tl.sweep(bundle, imgs, labels, rows, 100)
        ev[3].record()
        mask, _ = tl.ridge_select(rows, probs, labels, counts, 5, 0.25)
        ev[4].record()
        mask = mask.cpu()
        wall = time.perf_counter() - t0
    split = {s: ev[i].elapsed_time(ev[i + 1]) / 1e3
             for i, s in enumerate(stages)}
    if not (mask.sum() > 0 and int(counts[0]) > 1):
        fail(f"warm R101 LIME: {int(counts[0])} segments, "
             f"{int(mask.sum())} mask pixels")
    print(f"R101 warm LIME-1000: {wall:.4f} s/image wall "
          f"({int(counts[0])} segments); by stage (CUDA events): "
          + ", ".join(f"{s} {v:.4f} s" for s, v in split.items())
          + f" on {card}")
    return bundle, per_image


BATCH_METHODS = ("ig", "lig", "idg", "idgi", "grad", "inp_x_grad", "sg")


def tiny_cnn(torch, seed: int, device):
    """The model of xai_tpu's bf16 rank contract (tests/tiny_models.py,
    tests/test_batch_attr.py): two 3x3 stride-2 'SAME' convolutions (at
    16 px flax pads (0, 1)), ReLU, global mean, a dense layer of 10
    classes; seeded random weights."""
    import torch.nn as nn
    import torch.nn.functional as F

    from xai_tpu_torch.models.common import ModelBundle, ModelMeta
    from xai_tpu_torch.models.resnet import init_random

    class TinyCNN(nn.Module):
        def __init__(self):
            super().__init__()
            self.c1 = nn.Conv2d(3, 8, 3, 2)
            self.c2 = nn.Conv2d(8, 16, 3, 2)
            self.fc = nn.Linear(16, 10)

        def forward(self, x):
            x = F.relu(self.c1(F.pad(x, (0, 1, 0, 1))))
            x = F.relu(self.c2(F.pad(x, (0, 1, 0, 1))))
            return self.fc(x.mean(dim=(2, 3)))

    return ModelBundle(ModelMeta(name="tiny", family="cnn", img_hw=16,
                                 num_classes=10, batch_size=10),
                       init_random(TinyCNN(), seed).to(device))


def check_batch_reference(torch, dev):
    """Phase 5, batched: TINY_R at 32 px, three images, batch_attribution
    (sg through sg_batch with injected noise) and the batched battery on
    the card against the same code on the CPU, in float32; then the bf16
    sweep against float32 on the card."""
    import numpy as np

    from xai_tpu_torch.methods.batch import batch_attribution, sg_batch
    from xai_tpu_torch.ops.stats import spearman_np
    from xai_tpu_torch.parallel.sharded_battery import sharded_battery_scores
    from xai_tpu_torch.runners.common import (build_bundle, default_blur,
                                              normalize_input)

    # 32 px, not TINY_R's 64: TINY_R's random weights have zero biases,
    # so a ReLU input within float32 rounding of zero stays there at every
    # interpolation step and the device's summation order picks its side
    # for a whole sweep.  At 64 px (4x the units) these inputs met such a
    # unit and the card differed from the CPU by up to 8.4e-4; at 32 px
    # they meet none: each device's float32 lies within 1.2e-6 of its
    # float64, while TF32 convolutions differ by 9e-3 or more
    # (tools/torch_float32_parity_probe.py; PERF.md section 6).
    hw = 32
    imgs = np.random.RandomState(9).rand(3, hw, hw, 3).astype(np.float32)
    # sg's noise injected: 4 samples an image, the same on both devices
    noises = (0.5 * np.random.RandomState(12).randn(3, 4, hw, hw, 3)
              ).astype(np.float32)
    runs = []
    for d in (dev, torch.device("cpu")):
        bundle = build_bundle("TINY_R", seed=1, device=d)
        xs = torch.stack([normalize_input(im, "cnn", d) for im in imgs])
        targets = bundle.apply(xs.permute(0, 3, 1, 2)).argmax(-1).tolist()
        sals = {m: batch_attribution("cnn", m, bundle, xs, imgs, targets,
                                     None, img_hw=hw)
                for m in BATCH_METHODS if m != "sg"}
        sals["sg"] = sg_batch(bundle, xs, torch.tensor(targets, device=d),
                              noises=noises).cpu().numpy()
        runs.append((bundle, xs, targets, sals))
    (b_gpu, x_gpu, t_gpu, s_gpu), (b_cpu, x_cpu, t_cpu, s_cpu) = runs
    if t_gpu != t_cpu:
        fail(f"TINY_R batch argmax differs: cuda {t_gpu}, cpu {t_cpu}")
    errs = {m: float(np.abs(s_gpu[m] - s_cpu[m]).max()
                     / np.abs(s_cpu[m]).max()) for m in BATCH_METHODS}
    if not all(e < 1e-4 for e in errs.values()):
        fail(f"batched attribution on the card differs from the CPU: {errs}")
    print(f"TINY_R {hw} px, B=3, batch_attribution card vs CPU, float32 rel "
          "err (< 1e-4): " + ", ".join(f"{m} {e:.3g}"
                                       for m, e in errs.items()))

    blur = default_blur()
    sg_, sc_ = (sharded_battery_scores(b, x, s_cpu["ig"], blur, 45, t_cpu)
                for b, x in ((b_gpu, x_gpu), (b_cpu, x_cpu)))
    worst = max(abs(g[k] - c[k]) for g, c in zip(sg_, sc_) for k in c)
    if not (all(math.isfinite(v) for g in sg_ for v in g.values())
            and worst < 2e-3):
        fail(f"batched battery on the card differs from the CPU: {worst}")
    print(f"TINY_R {hw} px, B=3, sharded_battery_scores card vs CPU: max "
          f"|score delta| {worst:.3g} (< 2e-3)")

    # the bf16 contract of tests/test_batch_attr.py on its model and
    # inputs: ig at 8 steps, Spearman rho > 0.98 against float32; TINY_R's
    # rho is printed beside it (its random weights sit near 0.97 on the
    # CPU, in xai_tpu too)
    tiny = tiny_cnn(torch, 1, dev)
    xs16 = np.random.RandomState(9).randn(2, 16, 16, 3).astype(np.float32)
    rho = {}
    for label, b, xs, tg, px, steps in (
            ("tiny CNN 16 px", tiny, xs16, [2, 5], 16, 8),
            (f"TINY_R {hw} px", b_gpu, x_gpu, t_gpu, hw, 50)):
        f32, b16 = (batch_attribution("cnn", "ig", b, xs, None, tg, None,
                                      img_hw=px, steps=steps, dtype=dt)
                    for dt in (None, torch.bfloat16))
        rho[label] = min(spearman_np(f, h) for f, h in zip(f32, b16))
    if not rho["tiny CNN 16 px"] > 0.98:
        fail(f"bf16 ig on the card: Spearman rho {rho} against float32")
    print("bf16 ig against float32 on the card, least Spearman rho over "
          "the images: " + ", ".join(f"{k} {v:.4f}" for k, v in rho.items())
          + " (contract: tiny CNN > 0.98)")


def _event_s(torch, fn):
    """(result, seconds) of ``fn`` between two CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end) / 1e3


def time_warm_batch(torch, dev, card, bundle, per_image):
    """Phase 6, batched: R101 at --image_batch 4, each IG-family method in
    float32 and in bf16 and the batched battery, timed with CUDA events on
    a second, warm call; printed per image beside the per-image IG-50 and
    battery of this run."""
    import numpy as np

    from xai_tpu_torch.methods.batch import batch_attribution
    from xai_tpu_torch.ops.stats import spearman_np
    from xai_tpu_torch.parallel.sharded_battery import sharded_battery_scores
    from xai_tpu_torch.runners.common import default_blur, normalize_input

    b = 4
    imgs = np.random.RandomState(0).rand(b, 224, 224, 3).astype(np.float32)
    xs = torch.stack([normalize_input(im, "cnn", dev) for im in imgs])
    targets = [1, 2, 3, 4]
    per = {}
    sals = {}
    for dname, dtype in (("f32", None), ("bf16", torch.bfloat16)):
        for m in ("ig", "lig", "idg", "idgi", "sg"):
            torch.cuda.reset_peak_memory_stats(dev)
            for _ in range(2):               # the first call warms up
                sals[m, dname], sec = _event_s(torch, lambda: (
                    batch_attribution(
                        "cnn", m, bundle, xs, imgs, targets,
                        [torch.Generator(dev).manual_seed(i)
                         for i in range(b)], dtype=dtype)))
            per[m, dname] = sec / b
            peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
            if not np.isfinite(sals[m, dname]).all():
                fail(f"batched R101 {m} {dname}: non-finite saliency")
            print(f"R101 warm batched {m} {dname}: {per[m, dname]:.4f} "
                  f"s/image at B={b} (peak memory {peak:.2f} GiB)")
    for _ in range(2):
        scores, sec = _event_s(torch, lambda: sharded_battery_scores(
            bundle, xs, sals["ig", "f32"], default_blur(), 45, targets))
    if not all(math.isfinite(v) for s in scores for v in s.values()):
        fail("batched R101 battery: non-finite scores")
    per["battery"] = sec / b
    # zero-bias random weights give a zero gradient at the black image, so
    # a LIG cut at its first step leaves a constant map: rho is undefined
    with np.errstate(invalid="ignore"):
        rho = {m: min(spearman_np(f, h) for f, h in zip(sals[m, "f32"],
                                                        sals[m, "bf16"]))
               for m in ("ig", "lig", "idg", "idgi", "sg")}
    print(f"R101 warm at B={b}, s/image (CUDA events; per-image path of "
          f"this run: IG-50 {per_image['ig']:.4f}, battery "
          f"{per_image['battery']:.4f}): "
          + ", ".join(f"{m} f32 {per[m, 'f32']:.4f} / bf16 "
                      f"{per[m, 'bf16']:.4f}"
                      for m in ("ig", "lig", "idg", "idgi", "sg"))
          + f"; battery {per['battery']:.4f} on {card}")
    print("R101 random weights, bf16 against float32, least Spearman rho "
          "over the images: " + ", ".join(f"{m} {v:.4f}"
                                          for m, v in rho.items()))


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
    rows.append(check_quickshift(torch, dev))

    by_path = {}
    with tempfile.TemporaryDirectory() as out_dir:
        for label, *path in MAIN_PATHS:
            by_path[label] = run_main_path(torch, dev, out_dir, label, *path)
    check_small_reference(torch, dev)
    check_batch_reference(torch, dev)
    bundle, per_image = time_warm_image(torch, dev, card)
    time_warm_batch(torch, dev, card, bundle, per_image)

    for row in rows:
        name = row["name"]
        row["launches"] = sum(p[name] for p in by_path.values())
        row["launches_by_path"] = {a: p[name] for a, p in by_path.items()}
        lib = ("none" if row["library_ms"] is None
               else f"{row['library_ms'] * 1e3:.2f} us")
        print(f"{name}: kernel {row['ms'] * 1e3:.2f} us, plain "
              f"{row['plain_ms'] * 1e3:.2f} us, library {lib}, bound "
              f"{row['bound_ms'] * 1e3:.3f} us ({row['bound_by']}) on {card}")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
