#!/usr/bin/env python3
"""Chip smoke run of xai_tpu_torch, the PyTorch / CUDA port, on one GPU.

Run from the root of the repository, on a machine with an NVIDIA H100 and
the CUDA toolkit:

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) on any error:

1. the card's name and power limit (nvidia-smi); which of PIL, h5py,
   scikit-learn and matplotlib import (a phase that needs a missing one
   is left to the CPU tests, and the line says so); float32 stays
   float32 (TF32 off for cuDNN and cuBLAS);
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
   with torch.profiler; the blur wider than its fused kernel (two
   launches) at klen 65, 103, 161 and 449 on [3, 224, 224], and 103 on
   [2, 203, 97] and [12, 224, 224], klen 103 timed beside its bound and
   F.conv2d;
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
   class keeps every noise image, which random weights give one class);
   then each of the rest of the CNN family (gig, agi, gc, gbp, ggc, gs,
   fa, occ, shap, rise, xrai) with --synthetic 2 image by image, and the
   nine of them that batch (agi, gbp, gc, ggc, gs, fa, occ, shap, gig)
   with --image_batch 4 --synthetic 4 --image_count 4000 in float32, and
   shap in bf16.  Each CSV must hold 10 finite scores; each battery (a
   scored image, or a flush of a batch) must launch blur once (>= once
   image by image), reveal 3 passes * ceil(225 / 45) chunks = 15 times,
   and quickshift once on a LIME path and never on another; a batched
   path must score all its images in full batches; then the other
   drivers on R101, each through its entry point with its launches:
   sanity (ig, lime, ig at --image_batch 4 in bf16), segmentation (ig,
   gc at --image_batch 4), --save_maps image by image and at B=4 (the
   HDF5's maps are the scored ones; without h5py it must refuse), the
   image finder against ground truth that makes its mask 1,0,1,0,...,
   the 16-name qualitative panel (no failed name; the PNG where
   matplotlib imports) and the sweep (6 rows ok, each pert row blur 1
   and reveal 15 a scored image); sanity LIME's SPR and HOG may be NaN
   only where a map is constant, as xai_tpu's evaluate gives them;
5. check the answers against a reference on a small input: TINY_R at
   64 px on the card against the same code on the CPU (where every kernel
   wrapper runs its plain version): IG and the battery, and LIME with
   injected sample rows; at B=3 and 32 px (inputs that meet no ReLU kink
   within float32 rounding), batch_attribution of ig, lig, idg, idgi,
   grad and inp_x_grad, and sg_batch with injected noise, within 1e-4
   relative in float32, and the batched battery within 2e-3; bf16 ig
   against float32 on the card, Spearman rho > 0.98 on the tiny CNN of
   xai_tpu's bf16 contract; at B=3 and 32 px the nine batched names of
   the rest of the family (gs and shap with injected draws) and rise with
   injected masks, within 1e-4 relative in float32 (gig or agi, where a
   discrete choice falls the other way on the card in float32, is named,
   and held within 1e-4 on the model's float64 copy; float32 agi is
   held up to its first flipped choice: each flip a rounding-level tie,
   and AGI run for that many iterations within 1e-4 on both devices);
   TINY_R's sanity CSV and seg TXT (ig, gc) within 2e-3 of the CPU's,
   the randomized weights bit-equal;
6. time one warm IG-50 attribution, one warm battery and one warm LIME
   attribution of R101, LIME split by stage with CUDA events; then R101 at
   B=4: batched IG-50, LIG, IDG, IDGI and SG in float32 and in bf16, and
   the batched battery, per image, with CUDA events; then each of the
   rest of the family warm on R101, image by image and at B=4 (shap in
   bf16 too), with CUDA events and peak memory; sanity-ig and seg-ig per
   image, split into attribution and host metrics, and the image
   finder's images a second at --batch_size 100.

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
    # wider than the fused kernel's instantiations (MDA grows klen to
    # 103, nsig with it): the two-launch path, up to klen 449, wider than
    # twice a 224-px plane
    planes_r = torch.randn(2, 203, 97, device=dev, generator=gen)
    wide = [(planes, k) for k in (65, 103, 161, 449)] + [
        (planes_r, 103), (planes12, 103)]
    for t, klen in wide:
        before = kblur.blur_planes.launches
        got = kblur.blur_planes(t, klen, float(klen))
        if kblur.blur_planes.launches - before != 2:
            fail(f"blur klen {klen} launched "
                 f"{kblur.blur_planes.launches - before} kernels, not 2")
        want = kblur.blur_planes_plain(t, klen, float(klen))
        torch.cuda.synchronize()
        e = float((got - want).abs().max())
        print(f"blur_planes {list(t.shape)} klen {klen} (two launches): "
              f"max |kernel - plain| = {e:.3g}")
        if not (e < BLUR_TOL and bool(torch.isfinite(got).all())):
            fail(f"blur kernel at klen {klen} disagrees with its plain "
                 f"version: {e}")
        err = max(err, e)
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
    weight103 = torch.as_tensor(gkern(103, 103.0), device=dev).expand(
        3, 1, 103, 103).contiguous()
    row = rows[-1]
    row.update(
        ms_k103=device_ms(torch, lambda: kblur.blur_planes(planes, 103,
                                                           103.0)),
        plain_ms_k103=device_ms(torch, lambda: kblur.blur_planes_plain(
            planes, 103, 103.0)),
        library_ms_k103=device_ms(torch, lambda: F.conv2d(
            planes[None], weight103, padding=51, groups=3)),
        bound_ms_k103=blur_bound_ms(n, h, w, 103)[0],
        bound_by_k103=blur_bound_ms(n, h, w, 103)[1])
    print(f"blur [3, 224, 224] klen 103 (two launches): kernel "
          f"{row['ms_k103'] * 1e3:.2f} us, plain "
          f"{row['plain_ms_k103'] * 1e3:.2f} us, F.conv2d depthwise "
          f"{row['library_ms_k103'] * 1e3:.2f} us, bound "
          f"{row['bound_ms_k103'] * 1e3:.3f} us ({row['bound_by_k103']})")

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
# the rest of the CNN family (ROADMAP A8), and the names of it that
# xai_tpu batches
A8_NAMES = ("gig", "agi", "gc", "gbp", "ggc", "gs", "fa", "occ", "shap",
            "rise", "xrai")
A8_BATCHED = ("agi", "gbp", "gc", "ggc", "gs", "fa", "occ", "shap", "gig")
MAIN_PATHS += [(n, ["--attr_func", n], 2, 2, 1) for n in A8_NAMES]
MAIN_PATHS += [(f"{n}_b4", ["--attr_func", n], 4, 4000, 4)
               for n in A8_BATCHED]
MAIN_PATHS.append(("shap_b4_bf16", ["--attr_func", "shap", "--attr_dtype",
                                    "bf16"], 4, 4000, 4))
# 3 passes of ceil(225 / 45) = 5 reveal chunks at 224 px: 224 steps of 224
# pixels, plus step 0
REVEAL_PER_BATTERY = 3 * math.ceil((224 * 224 // 224 + 1) / 45)


def synthetic_classes(torch, dev, n: int) -> list:
    """R101's (seeded random weights, as the driver builds them) class of
    each of the first ``n`` images of the driver's --synthetic stream.
    AGI at the driver's topk=1 attacks class 0 only, and an image whose
    prediction is class 0 has no attack and maps to 0/0 = NaN, as in
    xai_tpu: the AGI paths need images of other classes.  With weight
    seed 0 and stream seed 0 (the driver's defaults) R101 gives none of
    them class 0; this checks it."""
    from xai_tpu_torch.data.imagenet import ImageNetValStream
    from xai_tpu_torch.runners.common import build_bundle, normalize_input

    bundle = build_bundle("R101", device=dev)
    xs = torch.stack([normalize_input(it.trans_img, "cnn", dev) for it in
                      ImageNetValStream("", 224, synthetic=n)])
    with torch.no_grad():
        classes = bundle.apply(xs.permute(0, 3, 1, 2)).argmax(-1).tolist()
    print(f"R101 classes of the {n} synthetic images: {classes}")
    if 0 in classes[:4]:        # the AGI paths score at most 4 of them
        fail("a synthetic image is class 0, the only class AGI attacks at "
             "topk=1: its AGI map would be NaN; choose another seed")
    return classes


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


# batch_attribution's production constants scaled to 32 px (patch grid
# 4x4, occlusion window 8 stride 4, 5 Shapley permutations), as in
# tests/test_torch_batch.py
SMALL_OPTS = {"num_patches": 4, "occ_window": 8, "occ_stride": 4,
              "shap_samples": 5}
A8_REL_TOL = 1e-4


def _rel_err(got, want) -> float:
    """max |got - want| / max |want|."""
    import numpy as np

    return float(np.abs(got - want).max() / np.abs(want).max())


def agi_choices(torch, bundle, x01, target: int = 0, max_iter: int = 20,
                epsilon: float = 0.05) -> list:
    """The discrete choices of AGI's attack toward ``target`` (the loop
    of xai_tpu_torch/methods/agi.py _agi_attack), iteration by iteration:
    each image's argmax and probabilities, the sign of the gradient toward
    the target, and that gradient's magnitude."""
    from xai_tpu_torch.methods.agi import _norm_apply

    pert = x01
    done = torch.zeros(x01.shape[0], dtype=torch.bool, device=x01.device)
    out = []
    for _ in range(max_iter):
        xg = pert.detach().requires_grad_(True)
        with torch.enable_grad():
            probs = torch.softmax(_norm_apply(bundle, xg), dim=-1)
            (g,) = torch.autograd.grad(probs[:, target].sum(), xg)
        newly = probs.detach().argmax(-1) == target
        new = torch.clamp(x01 + epsilon * torch.sign(g), 0.0, 1.0)
        pert = torch.where(~(done | newly)[:, None, None, None], new, pert)
        out.append((probs.detach().argmax(-1).cpu(), torch.sign(g).cpu(),
                    g.abs().cpu(), probs.detach().cpu()))
        done = done | newly
        if bool(done.all()):
            break
    return out


# a flipped choice is a rounding-level tie when the CPU's gradient at each
# flipped pixel (or the gap between the two classes of a flipped argmax)
# is at most this share of its image's largest
AGI_TIE = 1e-2


def first_agi_choice(card: list, cpu: list):
    """The first iteration k at which the card's choices differ from the
    CPU's: (k, what differs, the flipped choices' largest share of their
    image's largest gradient or probability), or (None, ..., None) when
    none differs."""
    for it, ((p1, s1, g1, q1), (p2, s2, g2, q2)) in enumerate(zip(card,
                                                                   cpu)):
        if not bool((p1 == p2).all()):
            rows = (p1 != p2).nonzero().flatten().tolist()
            tie = max(float((q2[i, p2[i]] - q2[i, p1[i]]) / q2[i, p2[i]])
                      for i in rows)
            return it, (f"iteration {it}: argmax on the card "
                        f"{p1.tolist()}, on the CPU {p2.tolist()}, "
                        f"probability gap <= {tie:.2e} of the top"), tie
        flip = s1 != s2
        if bool(flip.any()):
            tie = float((g2[flip] / g2.flatten(1).amax(1).view(-1, 1, 1, 1)
                         .expand_as(g2)[flip]).max())
            return it, (f"iteration {it}: the sign of the gradient toward "
                        f"the attacked class differs at {int(flip.sum())} "
                        f"pixels, each |gradient| <= {tie:.2e} of its "
                        f"image's largest"), tie
    return None, (f"none in the {min(len(card), len(cpu))} iterations "
                  f"compared"), None


def check_agi_float32(torch, runs, imgs, err: float) -> list:
    """C2: float32 AGI on the card against the CPU, up to the first
    iteration k whose choice differs: every flipped choice must be a
    rounding-level tie (AGI_TIE), and the maps of AGI run for k
    iterations on both devices (methods/agi.py max_iter) must agree
    within A8_REL_TOL.  Returns the failures."""
    import numpy as np

    from xai_tpu_torch.methods.agi import agi_batch

    k, choice, tie = first_agi_choice(
        *(agi_choices(torch, r["bundle"], r["x01"]) for r in runs))
    if k is None:
        return [f"agi: float32 rel err {err} though no choice differs"]
    failures = []
    if not tie <= AGI_TIE:
        failures.append(f"agi: a flipped choice is no rounding-level tie "
                        f"({tie:.3g} > {AGI_TIE}): {choice}")
    line = f"agi float32, card vs CPU: first differing choice at {choice}"
    if k > 0:
        maps = [agi_batch(r["bundle"], imgs, max_iter=k).abs().cpu().numpy()
                for r in runs]
        err_k = _rel_err(*maps)
        line += (f"; run for those {k} iterations on both devices, rel err "
                 f"{err_k:.3g} (< {A8_REL_TOL})")
        if not (err_k < A8_REL_TOL and all(np.isfinite(m).all()
                                           for m in maps)):
            failures.append(f"agi: float32 maps at max_iter={k} differ "
                            f"card vs CPU: {err_k}")
    print(line)
    return failures


def check_a8_reference(torch, dev):
    """Phase 5, the rest of the CNN family: TINY_R at 32 px, three images,
    on the card against the same code on the CPU.  gbp, gc, ggc, fa, occ,
    gig and agi go through batch_attribution; gs and shap through their
    batched cores with the same injected draws on both devices (the two
    devices' generators draw differently); rise with 200 injected masks.
    Each within 1e-4 relative in float32.  gig runs 8 steps, as in
    tests/test_torch_gig.py: at 50 a feature that lands one ulp short of
    its end point on one side of an exact equality test (``xc == x_max``)
    changes every later selection, and float32 and float64 differ by 0.36
    on the CPU alone.

    gig and agi make discrete choices at every step (gig: which features
    sit below the |gradient| quantile, and which already sit at their end
    point; agi: the sign of each gradient toward the attacked class, and
    each iteration's argmax), over many
    distinct inputs, and TINY_R's zero-bias random weights put some ReLU
    input within float32 rounding of zero on some of them: a choice then
    falls the other way, and the path after it differs.  Where that
    happens in float32, the check names the choice and prints the
    float32 error and Spearman rho, and holds the method card vs CPU on
    the bundle's float64 copy within 1e-4, where no choice can fall the
    other way on rounding.  Float32 agi, the driver's, is held besides up
    to its first flipped choice (check_agi_float32)."""
    import numpy as np

    from xai_tpu_torch.methods import ablation as AB
    from xai_tpu_torch.methods.batch import batch_attribution
    from xai_tpu_torch.methods.rise import masks_from_grid, rise
    from xai_tpu_torch.ops.stats import spearman_np
    from xai_tpu_torch.runners.common import build_bundle, normalize_input

    hw, b = 32, 3
    imgs = np.random.RandomState(9).rand(b, hw, hw, 3).astype(np.float32)
    rs = np.random.RandomState(13)
    gs_draws = [(rs.randn(1, hw, hw, 3).astype(np.float32),
                 rs.rand(5).astype(np.float32), np.zeros(5, np.int64))
                for _ in range(b)]
    perms = np.stack([[rs.permutation(16) for _ in range(5)]
                      for _ in range(b)])
    grid = (rs.rand(200, 8, 8) < 0.5).astype(np.float32)
    offsets = rs.randint(0, 4, (200, 2))
    runs = []
    for d in (dev, torch.device("cpu")):
        bundle = build_bundle("TINY_R", seed=1, device=d)
        xs = torch.stack([normalize_input(im, "cnn", d) for im in imgs])
        x = xs.permute(0, 3, 1, 2)
        with torch.no_grad():
            targets = bundle.apply(x).argmax(-1).tolist()
        tg = torch.tensor(targets, device=d)

        def batched(m, dtype=None):
            return batch_attribution("cnn", m, bundle, xs, imgs, targets,
                                     None, img_hw=hw, steps=8, dtype=dtype,
                                     opts=SMALL_OPTS)

        sals = {m: batched(m) for m in ("gbp", "gc", "ggc", "fa", "occ",
                                        "gig", "agi")}
        draws = [tuple(torch.as_tensor(t, device=d) for t in dr)
                 for dr in gs_draws]
        sals["gs"] = AB.gradient_shap_batch(bundle, x, tg, draws) \
            .sum(dim=1).abs().cpu().numpy()
        sals["shap"] = (3.0 * AB.shapley_batch(
            bundle, x, tg, torch.as_tensor(perms, device=d), 4).abs()
        ).cpu().numpy()
        masks = masks_from_grid(torch.as_tensor(grid, device=d),
                                torch.as_tensor(offsets, device=d), hw)
        sals["rise"] = rise(bundle, xs[0], targets[0], masks=masks) \
            .cpu().numpy()[None]
        f64 = {m: batched(m, torch.float64) for m in ("gig", "agi")}
        runs.append(dict(targets=targets, sals=sals, f64=f64, bundle=bundle,
                         x01=torch.as_tensor(imgs, device=d)
                         .permute(0, 3, 1, 2)))
    card, cpu = runs
    if card["targets"] != cpu["targets"]:
        fail(f"TINY_R 32 px argmax differs: cuda {card['targets']}, cpu "
             f"{cpu['targets']}")
    report, failures = {}, []
    for m in sorted(cpu["sals"]):
        got, want = card["sals"][m], cpu["sals"][m]
        err = _rel_err(got, want)
        if err < A8_REL_TOL:
            report[m] = f"{err:.3g}"
            continue
        if m not in card["f64"]:
            failures.append(f"{m}: rel err {err}")
            continue
        rho = min(spearman_np(g, c) for g, c in zip(got, want))
        if m == "agi":
            failures += check_agi_float32(torch, runs, imgs, err)
            choice = "above"
        else:
            choice = (f"{int((got != want).sum())} of {got.size} pixels "
                      f"differ (which features a step moves: those below "
                      f"its |gradient| quantile, and those already at "
                      f"their end point)")
        err64 = _rel_err(card["f64"][m], cpu["f64"][m])
        print(f"{m}: float32 card vs CPU rel err {err:.3g}, least Spearman "
              f"rho {rho:.5f}: a discrete choice fell the other way, "
              f"{choice}; float64 copy card vs CPU rel err {err64:.3g} "
              f"(< {A8_REL_TOL})")
        if not err64 < A8_REL_TOL:
            failures.append(f"{m}: float64 rel err {err64}")
        report[m] = f"{err64:.3g} in float64"
    if failures:
        fail("the rest of the CNN family on the card differs from the CPU: "
             + "; ".join(failures))
    print(f"TINY_R 32 px, B=3 (classes {cpu['targets']}), the rest of the "
          f"CNN family card vs CPU, rel err (< {A8_REL_TOL}; float32 unless "
          f"noted): " + ", ".join(f"{m} {e}" for m, e in report.items()))


# packages the port needs only on some paths, and the machine with the
# card need not have: h5py (--save_maps), matplotlib (the qualitative
# grid's PNG); PIL and scikit-learn for the record (the port reads no
# image file here, and never imports scikit-learn)
OPTIONAL_PACKAGES = ("PIL", "h5py", "sklearn", "matplotlib")


def optional_packages() -> dict:
    """Which optional packages import here; prints one line."""
    import importlib.util

    have = {n: importlib.util.find_spec(n) is not None
            for n in OPTIONAL_PACKAGES}
    skipped = [f"{what} (needs {n})" for n, what in
               (("h5py", "the --save_maps paths"),
                ("matplotlib", "the qualitative grid's PNG"))
               if not have[n]]
    print("optional packages: " + ", ".join(
        f"{n} {'imports' if ok else 'missing'}" for n, ok in have.items())
        + ("; covered by the CPU tests only: " + ", ".join(skipped)
           if skipped else "; every driven phase runs"))
    return have


NO_LAUNCHES = {"blur_planes": 0, "reveal_batch": 0, "quickshift_parents": 0}


def run_path(torch, label, fn, want: dict):
    """Drive one path, every kernel counter zeroed just before and read
    just after; fails unless each kernel launched as ``want`` says.
    Returns (fn's result, the launches)."""
    wrappers = kernel_wrappers()
    for w in wrappers.values():
        w.launches = 0
    log = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(log):
        result = fn()
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    launches = {n: w.launches for n, w in wrappers.items()}
    print(log.getvalue(), end="")
    if launches != want:
        fail(f"the {label} path launched {launches}, expected {want}")
    print(f"{label} path: {total:.3f} s, launches {json.dumps(launches)}")
    return result, launches


def _finite_scores(label, scores: dict, keys) -> None:
    print(f"{label} scores:", json.dumps(scores))
    if list(scores) != list(keys) or not all(math.isfinite(v)
                                             for v in scores.values()):
        fail(f"{label}: expected finite {list(keys)}, got {scores}")


def _read_sanity_csv(path) -> dict:
    with open(path) as f:
        rows = {r[0]: float(r[1]) for r in csv.reader(f) if r}
    del rows["Total Runtime"]
    return rows


def _read_seg_txt(path) -> dict:
    """The seg driver's TXT as {line label: number} (pixel accuracy in
    percent, as written)."""
    with open(path) as f:
        return {line.split(":")[0]: float(line.split(":")[1].strip(" %\n"))
                for line in f}


SANITY_KEYS = ("SSIM", "SPR", "HOG")
SEG_LINES = ("Mean IoU over 2 classes", "Pixel-wise Accuracy",
             "Mean AP over 2 classes", "Mean F1 over 2 classes")


def check_constant_lime(scores: dict, maps: list) -> None:
    """The sanity driver's LIME scores on R101.  The randomized model
    (every convolution redrawn, the folded batch norms left) puts its
    logits in the millions: every LIME sample's softmax is one-hot at the
    same class, the ridge finds no positive segment and the map is
    constant.  xai_tpu's ``evaluate`` then gives SSIM on its zeroed map
    but NaN Spearman and HOG Spearman (the Spearman of a constant
    vector), and so does the port.  SSIM must be finite; SPR and HOG are
    NaN exactly where an image has a constant map, else finite."""
    import numpy as np

    pairs = list(zip(maps[0::2], maps[1::2]))      # (trained, randomized)
    constant = [float(np.ptp(a)) == 0 or float(np.ptp(b)) == 0
                for a, b in pairs]
    print("sanity_lime scores:", json.dumps(scores))
    nan = [k for k, v in scores.items() if not math.isfinite(v)]
    want = ["SPR", "HOG"] if any(constant) else []
    if list(scores) != list(SANITY_KEYS) or nan != want or len(pairs) != 2:
        fail(f"sanity_lime: scores {scores}, constant maps {constant}")
    print(f"sanity_lime: {sum(constant)} of {len(pairs)} images have a "
          f"constant map (randomized model: "
          f"{[float(np.ptp(b)) == 0 for _, b in pairs]}; trained model: "
          f"{[float(np.ptp(a)) == 0 for a, _ in pairs]}); SSIM finite, "
          f"SPR and HOG {'NaN, as xai_tpu gives them' if want else 'finite'}")


def check_saved_maps(torch, dev, out_dir, label, flags, n_images, count,
                     batch):
    """--save_maps on the flagship driver: the HDF5 holds one map a scored
    image, equal to the map the battery scored."""
    import h5py
    import numpy as np

    from xai_tpu_torch.runners import evaluate_perturbation as ep

    scored = []
    battery, sharded = ep.run_battery, ep.sharded_battery_scores

    def spy_battery(apply, x, saliency, *args, **kwargs):
        scored.append(np.array(saliency))
        return battery(apply, x, saliency, *args, **kwargs)

    def spy_sharded(bundle, xs, sals, *args, **kwargs):
        scored.extend(np.array(s) for s in sals)
        return sharded(bundle, xs, sals, *args, **kwargs)

    ep.run_battery, ep.sharded_battery_scores = spy_battery, spy_sharded
    try:
        launches = run_main_path(torch, dev, out_dir, label,
                                 flags + ["--save_maps"], n_images, count,
                                 batch)
    finally:
        ep.run_battery, ep.sharded_battery_scores = battery, sharded
    with h5py.File(os.path.join(out_dir, label, "R101_ig_maps.h5")) as f:
        saved = [(n, np.asarray(d), dict(d.attrs))
                 for n, d in sorted(f["maps"].items())]
    ok = len(saved) == len(scored) > 0 and all(
        np.array_equal(m, s) and set(a) == {"target", "original_pred"}
        for (_, m, a), s in zip(saved, scored))
    if not ok:
        fail(f"{label}: the HDF5 holds {len(saved)} maps for {len(scored)} "
             f"scored images, or a map differs from the one scored")
    print(f"{label}: the HDF5 holds one map a scored image "
          f"({len(saved)}), each equal to the map the battery scored")
    return launches


def drive_driver_paths(torch, dev, out_dir, classes, have) -> dict:
    """Phase 4, the other drivers on R101 at 224 px: sanity (ig, lime, ig
    batched in bf16), segmentation (ig, gc batched), the flagship's
    --save_maps image by image and batched, the image finder, the
    qualitative panel and the sweep; each through its entry point, with
    its launches.  Returns the launches by path."""
    import numpy as np

    from xai_tpu_torch.runners import evaluate_imagenet_seg as eg
    from xai_tpu_torch.runners import evaluate_sanity as es
    from xai_tpu_torch.runners import image_finder as fi
    from xai_tpu_torch.runners import qualitative_generation as qg
    from xai_tpu_torch.runners import sweep as sw

    by_path = {}
    for label, flags, qs in (
            ("sanity_ig", ["--attr_func", "ig", "--synthetic", "2",
                           "--image_count", "2"], 0),
            # LIME segments each image once a weight set
            ("sanity_lime", ["--attr_func", "lime", "--synthetic", "2",
                             "--image_count", "2"], 4),
            ("sanity_ig_b4_bf16", ["--attr_func", "ig", "--image_batch",
                                   "4", "--synthetic", "4", "--image_count",
                                   "4000", "--attr_dtype", "bf16"], 0)):
        d = os.path.join(out_dir, label)
        args = es.build_parser().parse_args(
            ["--model", "R101", *flags, "--output_dir", d])
        maps = []
        attribution = es.get_attribution

        def spy(*a, **k):
            maps.append(np.asarray(attribution(*a, **k)))
            return maps[-1]

        es.get_attribution = spy       # the per-image path's maps
        try:
            _, by_path[label] = run_path(
                torch, label, lambda: es.evaluate_sanity(args, device=dev),
                dict(NO_LAUNCHES, quickshift_parents=qs))
        finally:
            es.get_attribution = attribution
        scores = _read_sanity_csv(os.path.join(
            d, "R101", f"{args.attr_func}_{args.image_count}_images.csv"))
        if label == "sanity_lime":
            check_constant_lime(scores, maps)
        else:
            _finite_scores(label, scores, SANITY_KEYS)
    for label, flags in (
            ("seg_ig", ["--attr_func", "ig", "--synthetic", "2"]),
            ("seg_gc_b4", ["--attr_func", "gc", "--image_batch", "4",
                           "--synthetic", "4"])):
        d = os.path.join(out_dir, label)
        args = eg.build_parser().parse_args(
            ["--model", "R101", *flags, "--output_dir", d])
        _, by_path[label] = run_path(
            torch, label, lambda: eg.evaluate_imagenet_seg(args, device=dev),
            NO_LAUNCHES)
        _finite_scores(label, _read_seg_txt(os.path.join(
            d, "R101", f"{args.attr_func}_0_images")), SEG_LINES)

    if have["h5py"]:
        for label, batch, n, count in (("ig_save_maps", 1, 2, 2),
                                       ("ig_b4_save_maps", 4, 4, 4000)):
            by_path[label] = check_saved_maps(
                torch, dev, out_dir, label, ["--attr_func", "ig"], n, count,
                batch)
    else:
        # without h5py --save_maps must refuse before any work, never
        # write nothing silently
        from xai_tpu_torch.runners import evaluate_perturbation as ep

        d = os.path.join(out_dir, "save_maps_without_h5py")
        args = ep.build_parser().parse_args(
            ["--model", "R101", "--synthetic", "1", "--image_count", "1",
             "--save_maps", "--output_dir", d])
        try:
            ep.evaluate_perturbation(args, device=dev)
            fail("--save_maps ran without h5py")
        except ImportError as e:
            if "h5py" not in str(e) or os.path.exists(d):
                fail(f"--save_maps without h5py: {e}")
            print(f"--save_maps without h5py raises before any work: {e}")

    # the image finder, against ground truth that names the model's own
    # class at even indices and another at odd ones
    gt = os.path.join(out_dir, "ground_truth.txt")
    with open(gt, "w") as f:
        f.writelines(f"{c if i % 2 == 0 else (c + 1) % 1000}\n"
                     for i, c in enumerate(classes))
    args = fi.build_parser().parse_args(
        ["--model", "R101", "--synthetic", str(len(classes)),
         "--batch_size", "4", "--ground_truth", gt, "--class_maps_dir",
         os.path.join(out_dir, "class_maps")])
    mask, by_path["image_finder"] = run_path(
        torch, "image_finder",
        lambda: fi.find_correctly_classified(args, device=dev), NO_LAUNCHES)
    on_disk = np.loadtxt(os.path.join(
        out_dir, "class_maps", "correctly_classified_R101.txt")).tolist()
    want = [1, 0] * (len(classes) // 2)
    if mask.tolist() != want or on_disk != want:
        fail(f"image_finder mask {mask.tolist()} (file {on_disk}), "
             f"expected {want}")
    print(f"image_finder: mask {mask.tolist()} as constructed")

    # the qualitative panel: every CNN name on one image, LIME's
    # quickshift once; the grid's PNG where matplotlib imports
    panels = []
    panel_maps = qg.panel_maps

    def spy(*a, **k):
        panels.append(panel_maps(*a, **k))
        return panels[-1]

    qg.panel_maps = spy
    try:
        if have["matplotlib"]:
            args = qg.build_parser().parse_args(
                ["--model", "R101", "--synthetic", "1", "--output_dir",
                 os.path.join(out_dir, "qualitative")])
            written, by_path["qualitative"] = run_path(
                torch, "qualitative", lambda: qg.generate(args, device=dev),
                dict(NO_LAUNCHES, quickshift_parents=1))
            if list(written.values()) != [[]] or not all(
                    os.path.getsize(p) > 0 for p in written):
                fail(f"qualitative grid: {written}")
        else:
            from xai_tpu_torch.data.imagenet import ImageNetValStream
            from xai_tpu_torch.runners.common import build_bundle

            bundle = build_bundle("R101", device=dev)
            item = next(iter(ImageNetValStream("", 224, synthetic=1)))
            _, by_path["qualitative"] = run_path(
                torch, "qualitative", lambda: qg.panel_maps(
                    bundle, item, qg.CNN_PANEL, 0, dev),
                dict(NO_LAUNCHES, quickshift_parents=1))
    finally:
        qg.panel_maps = panel_maps
    maps, failed = panels[0]
    if failed or sorted(maps) != sorted(qg.CNN_PANEL) or not all(
            np.isfinite(m).all() and m.shape == (224, 224)
            for m in maps.values()):
        fail(f"qualitative panel: failed {failed}, maps {sorted(maps)}")
    print(f"qualitative: {len(maps)} of the {len(qg.CNN_PANEL)} CNN panel "
          f"maps, finite, none failed"
          + ("; grid written" if have["matplotlib"] else ""))

    # the sweep: 6 runs; each pert run scores one image a class (the
    # quota at --image_count 2) and launches blur once and reveal 15 times
    # a scored image
    d = os.path.join(out_dir, "sweep")
    args = sw.build_parser().parse_args(
        ["--drivers", "pert,sanity,seg", "--models", "R101", "--methods",
         "ig,gc", "--synthetic", "2", "--image_count", "2", "--output_dir",
         d])
    scored = 2 * len(set(classes[:2]))
    records, by_path["sweep"] = run_path(
        torch, "sweep", lambda: sw.run_sweep(args, device=dev),
        dict(NO_LAUNCHES, blur_planes=scored,
             reveal_batch=REVEAL_PER_BATTERY * scored))
    with open(os.path.join(d, "sweep_manifest.jsonl")) as f:
        manifest = [json.loads(line) for line in f]
    if len(manifest) != 6 or records != manifest or not all(
            r["status"] == "ok" and all(math.isfinite(v) for v in
                                        r["scores"].values())
            for r in manifest):
        fail(f"sweep manifest: {manifest}")
    print("sweep: 6 manifest rows, all ok: " + ", ".join(
        f"{r['driver']}/{r['attr_func']} {r['seconds']} s" for r in manifest))
    return by_path


def check_tiny_drivers(torch, dev):
    """Phase 5, the other drivers: TINY_R at 64 px on the card against the
    CPU: the sanity driver's randomized weights bit-equal, the sanity
    CSV and the segmentation TXT of ig and gc within the driver CSV
    tolerance, 2e-3."""
    from xai_tpu_torch.runners import evaluate_imagenet_seg as eg
    from xai_tpu_torch.runners import evaluate_sanity as es
    from xai_tpu_torch.runners.common import build_bundle

    cpu = torch.device("cpu")
    weights = [{k: v.cpu() for k, v in es.randomize_family(
        build_bundle("TINY_R", device=d), "cnn",
        torch.Generator().manual_seed(1)).module.state_dict().items()}
        for d in (dev, cpu)]
    if not all(torch.equal(weights[0][k], weights[1][k])
               for k in weights[1]):
        fail("the sanity driver's randomized weights differ card vs CPU")
    report = []
    with tempfile.TemporaryDirectory() as out_dir:
        for name in ("ig", "gc"):
            for drv, fn, parser in (
                    ("sanity", es.evaluate_sanity, es.build_parser),
                    ("seg", eg.evaluate_imagenet_seg, eg.build_parser)):
                flags = ["--model", "TINY_R", "--attr_func", name,
                         "--synthetic", "3", "--output_dir", out_dir]
                if drv == "sanity":
                    flags += ["--image_count", "3"]
                got, want = (fn(parser().parse_args(flags), device=d)
                             for d in (dev, cpu))
                worst = max(abs(got[k] - want[k]) for k in want)
                report.append(f"{drv} {name} {worst:.3g}")
                if not (worst < 2e-3 and all(math.isfinite(v)
                                             for v in got.values())):
                    fail(f"TINY_R {drv} {name} on the card differs from "
                         f"the CPU: {got} vs {want}")
    print("TINY_R 64 px, the other drivers card vs CPU: randomized weights "
          "bit-equal; max |score delta| (< 2e-3): " + ", ".join(report))


def time_warm_drivers(torch, dev, card, bundle):
    """Phase 6, the other drivers on R101, warm: sanity-ig per image (its
    two IG-50 attributions with CUDA events, the host SSIM / Spearman /
    HOG), seg-ig per image (attribution, host metrics), and the image
    finder's images a second at --batch_size 100 (the driver end to end,
    and its batched forward alone)."""
    import numpy as np

    from xai_tpu_torch.data.segmentation import ImagenetSegmentation
    from xai_tpu_torch.metrics.sanity import evaluate as sanity_evaluate
    from xai_tpu_torch.metrics.seg import eval_batch
    from xai_tpu_torch.registry import get_attribution
    from xai_tpu_torch.runners import evaluate_sanity as es
    from xai_tpu_torch.runners import image_finder as fi
    from xai_tpu_torch.runners.common import (attr_context, build_bundle,
                                              normalize_input,
                                              predict_classes)

    rand = es.randomize_family(bundle, "cnn",
                               torch.Generator().manual_seed(1))
    item = next(iter(ImagenetSegmentation("", 224, synthetic=1)))
    x = normalize_input(item.trans_img, "cnn", dev)

    def ig(b):
        p = {"x": x, "trans_img": item.trans_img, "generator": None,
             "target": predict_classes(b, x[None])[0]}
        return get_attribution("cnn", "ig", attr_context(b, p))

    for _ in range(2):                      # the first round warms up
        a, t_a = _event_s(torch, lambda: ig(bundle))
        ar, t_r = _event_s(torch, lambda: ig(rand))
        t0 = time.perf_counter()
        sanity_evaluate(a, ar)
        t_host = time.perf_counter() - t0
        t0 = time.perf_counter()
        eval_batch(a, item.gt_mask)
        t_seg = time.perf_counter() - t0
    print(f"R101 warm sanity-ig: {t_a + t_r + t_host:.4f} s/image = IG-50 "
          f"trained {t_a:.4f} + IG-50 randomized {t_r:.4f} (CUDA events) + "
          f"host SSIM/Spearman/HOG {t_host:.4f}; seg-ig: "
          f"{t_a + t_seg:.4f} s/image = IG-50 {t_a:.4f} + host metrics "
          f"{t_seg:.4f} on {card}")

    n = 500
    with tempfile.TemporaryDirectory() as d:
        gt = os.path.join(d, "gt.txt")
        with open(gt, "w") as f:
            f.write("1\n" * n)
        args = fi.build_parser().parse_args(
            ["--model", "R101", "--synthetic", str(n), "--batch_size", "100",
             "--ground_truth", gt, "--class_maps_dir", d])
        for _ in range(2):                  # the first round warms up
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()):
                fi.find_correctly_classified(args, device=dev)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    build_bundle("R101", device=dev)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    xs = torch.as_tensor(np.random.RandomState(1).rand(100, 224, 224, 3),
                         dtype=torch.float32, device=dev)
    for _ in range(2):
        _, t_fwd = _event_s(torch, lambda: predict_classes(bundle, xs))
    print(f"R101 warm image_finder at --batch_size 100: "
          f"{n / (wall - t_build):.1f} images/s end to end ({n} synthetic "
          f"images in {wall:.3f} s, of it {t_build:.3f} s building the "
          f"bundle); the batched forward alone {100 / t_fwd:.1f} images/s "
          f"({t_fwd * 1e3:.2f} ms a batch of 100, CUDA events) on {card}")


def time_warm_a8(torch, dev, card, bundle):
    """Phase 6, the rest of the CNN family: one warm attribution of R101
    per method image by image (through the registry, as the driver calls
    it) and at B=4 (batch_attribution; shap in bf16 too), with CUDA
    events, and the peak memory of each.  Phase 4 has run every one of
    them at these shapes, so every call here is warm."""
    import numpy as np

    from xai_tpu_torch.methods.batch import batch_attribution
    from xai_tpu_torch.registry import AttrContext, get_attribution
    from xai_tpu_torch.runners.common import normalize_input

    imgs = np.random.RandomState(0).rand(4, 224, 224, 3).astype(np.float32)
    xs = torch.stack([normalize_input(im, "cnn", dev) for im in imgs])
    with torch.no_grad():
        targets = bundle.apply(xs.permute(0, 3, 1, 2)).argmax(-1).tolist()
    if 0 in targets:
        fail(f"a timing image is class 0 (AGI would map it to NaN): "
             f"{targets}")
    out = {}
    for name in A8_NAMES:
        torch.cuda.reset_peak_memory_stats(dev)
        ctx = AttrContext(bundle=bundle, x=xs[0], trans_img=imgs[0],
                          target=targets[0],
                          generator=torch.Generator(dev).manual_seed(0))
        sal, sec = _event_s(torch, lambda: get_attribution("cnn", name,
                                                           ctx))
        if not np.isfinite(sal).all():
            fail(f"warm R101 {name}: non-finite saliency")
        out[name, "image"] = (sec, torch.cuda.max_memory_allocated(dev))
    for name, dname, dtype in ([(n, "f32", None) for n in A8_BATCHED]
                               + [("shap", "bf16", torch.bfloat16)]):
        torch.cuda.reset_peak_memory_stats(dev)
        gens = [torch.Generator(dev).manual_seed(i) for i in range(4)]
        sal, sec = _event_s(torch, lambda: batch_attribution(
            "cnn", name, bundle, xs, imgs, targets, gens, dtype=dtype))
        if not np.isfinite(sal).all():
            fail(f"warm R101 {name} {dname} at B=4: non-finite saliency")
        out[name, f"b4 {dname}"] = (sec / 4,
                                    torch.cuda.max_memory_allocated(dev))
    for (name, kind), (sec, peak) in out.items():
        print(f"R101 warm {name} {kind}: {sec:.4f} s/image (peak memory "
              f"{peak / 2 ** 30:.2f} GiB)")
    time_gig_inner_loop(torch, dev, bundle, xs[0], imgs[0], targets[0])
    print("R101 warm, the rest of the CNN family, s/image (CUDA events), "
          "image by image / B=4 f32: "
          + ", ".join(f"{n} {out[n, 'image'][0]:.4f}"
                      + (f" / {out[n, 'b4 f32'][0]:.4f}"
                         if (n, "b4 f32") in out else "")
                      for n in A8_NAMES)
          + f"; shap B=4 bf16 {out['shap', 'b4 bf16'][0]:.4f} on {card}")


def time_gig_inner_loop(torch, dev, bundle, x, img, target):
    """Guided IG's time split: its 50 softmax gradients, timed alone, and
    the inner path search, the rest.  Each inner iteration takes one
    torch.kthvalue and one host sync; counting kthvalue's calls counts
    the iterations."""
    from xai_tpu_torch.methods.gig import _softmax_grad
    from xai_tpu_torch.registry import AttrContext, get_attribution

    ctx = AttrContext(bundle=bundle, x=x, trans_img=img, target=target)
    calls = []
    kthvalue = torch.kthvalue

    def counted(*args, **kwargs):
        calls.append(1)
        return kthvalue(*args, **kwargs)

    torch.kthvalue = counted
    try:
        _, sec = _event_s(torch, lambda: get_attribution("cnn", "gig", ctx))
    finally:
        torch.kthvalue = kthvalue
    x1 = x.permute(2, 0, 1)[None].contiguous()
    tg = torch.tensor([target], device=dev)
    _, grad_sec = _event_s(torch, lambda: [_softmax_grad(bundle, x1, tg)
                                           for _ in range(50)])
    n = len(calls)
    print(f"R101 warm gig image by image: {sec:.4f} s = 50 softmax "
          f"gradients {grad_sec:.4f} s + {n} inner iterations "
          f"{sec - grad_sec:.4f} s ({(sec - grad_sec) / max(n, 1) * 1e3:.3f}"
          f" ms each, one host sync each)")


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
    have = optional_packages()
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

    classes = synthetic_classes(torch, dev, 8)
    by_path = {}
    with tempfile.TemporaryDirectory() as out_dir:
        for label, *path in MAIN_PATHS:
            by_path[label] = run_main_path(torch, dev, out_dir, label, *path)
        by_path.update(drive_driver_paths(torch, dev, out_dir, classes,
                                          have))
    check_small_reference(torch, dev)
    check_batch_reference(torch, dev)
    check_a8_reference(torch, dev)
    check_tiny_drivers(torch, dev)
    bundle, per_image = time_warm_image(torch, dev, card)
    time_warm_batch(torch, dev, card, bundle, per_image)
    time_warm_a8(torch, dev, card, bundle)
    time_warm_drivers(torch, dev, card, bundle)

    for row in rows:
        name = row["name"]
        row["launches"] = sum(p[name] for p in by_path.values())
        row["launches_by_path"] = {a: p[name] for a, p in by_path.items()}
        lib = ("none" if row["library_ms"] is None
               else f"{row['library_ms'] * 1e3:.2f} us")
        print(f"{name}: kernel {row['ms'] * 1e3:.2f} us, plain "
              f"{row['plain_ms'] * 1e3:.2f} us, library {lib}, bound "
              f"{row['bound_ms'] * 1e3:.3f} us ({row['bound_by']}) on {card}")
    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
