#!/usr/bin/env python3
"""Chip smoke run of xai_tpu_torch, the PyTorch / CUDA port, on one GPU.

Run from the root of the repository, on a machine with an NVIDIA H100 and
the CUDA toolkit:

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) on any error:

1. the card's name and power limit (nvidia-smi); which of PIL (and its
   WebP encoder), h5py, scikit-learn and matplotlib import (a phase that
   needs a missing one is left to the CPU tests, and the line says so); float32 stays
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
   [4, 45, 3, 224, 224], at the battery's launches [3, 45, 3, 224, 224]
   (image by image) and [12, 45, 3, 224, 224] (B=4), at a ragged B=3,
   S=7 on 3x15x13 (the scalar variant) and at B=1 against reveal_chunk,
   and timed at B=4 and at the battery's two launches beside torch.where
   over the batch and its bound; the ResNet epilogue
   (bn_act) is checked bit-exact in its three forms at every R101 plane
   size, ragged ones and a misaligned view, with NaN, infinities and signed
   zeros, and on a whole R101 forward against the plain path (100
   launches), then timed at each pass of a 180-row forward (B=4) beside
   its bytes bound, its plain version and addcmul + add_ + relu_, and of
   a 135-row one (image by image) beside its bound; the fused LayerNorm
   (layernorm) within 4 ulps of its plain version at every width the
   cells run and ragged row counts, on a ViT-B/16 and a Swin-B forward
   (one launch a LayerNorm), then timed at each LayerNorm of both
   models' 180-row forwards beside its bytes bound, its plain version
   and F.layer_norm, with each whole forward with and without it;
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
   image by image), reveal ceil(225 / 45) = 5 times (a chunk's launch
   holds all three passes) and run 5 battery forwards (the counter
   battery_forwards) a battery of one image, 10 of two, 15 of four, and
   at least 100 bn_act launches a battery forward on R101 (each a fused
   R101 forward), bn_act and layernorm as often as the path's forwards
   pass their gates (FusedPasses), and quickshift once on a
   LIME path and never on another; a batched path must score all its
   images in full batches; then the other
   drivers on R101, each through its entry point with its launches:
   sanity (ig, lime, ig at --image_batch 4 in bf16), segmentation (ig,
   gc at --image_batch 4), --save_maps image by image and at B=4 (the
   HDF5's maps are the scored ones; without h5py it must refuse), the
   image finder against ground truth that makes its mask 1,0,1,0,...,
   the 16-name qualitative panel (no failed name; the PNG where
   matplotlib imports) and the sweep (6 rows ok, each pert row blur 1
   and reveal 5 a scored image); sanity LIME's SPR and HOG may be NaN
   only where a map is constant, as xai_tpu's evaluate gives them;
   then the ViT family (ROADMAP A10 slice 1) on VIT16 at 224 px with
   seeded random weights: each of its 11 names (attn, grad, cam_attn,
   n_rollout, rollout, t_attn, attn_ig, attn_attr, bi_attn, InFlow,
   t_attr) image by image (--synthetic 2) and at --image_batch 4
   --synthetic 4 --image_count 4000 in float32, rollout, t_attr and
   bi_attn in bf16, rollout and t_attr (B=4) on VIT32 (each battery blur
   1, reveal 5, quickshift 0); the sanity driver (rollout, t_attr at
   B=4 in bf16; SPR and HOG NaN only where a map is constant), the seg
   driver (rollout, t_attr at B=4), the image finder, the 11-name ViT
   panel (no name fails) and the sweep's ViT rows (pert, sanity, seg x
   rollout, t_attr); then the rest of the ViT family (ROADMAP A10 slice
   2) on VIT16: TIS, VIT_CX, MDA and MDA_dense on one image each in
   float32, TIS and VIT_CX in bf16, VIT_CX at --image_batch 4 in float32
   and bf16 (MDA: the battery's 5 reveals and its rescoring's 18; blur
   once a tried klen of its adaptive blur, twice above 63, the klen it
   stopped at printed), MDA on a copy of VIT16 with one class's head bias
   raised, where the adaptive blur must pass klen 63; MDA_dense through
   the seg driver; imagenet_seg_eval with rollout and
   Calibrate_Best_Possible; the sweep's slice-2 rows on VIT32 (pert,
   sanity, seg x the four names); then the CLIP family (ROADMAP A11) on
   CLIP16 at 224 px with seeded random weights and its real 1000-prompt
   table: each of its 12 names (eclip, eclip_nograd, eclip_wo, maskclip,
   grad_cam, selfattn, game, rollout, lrp, m2ib, surgery, rise) image by
   image on two images of two classes (random CLIP weights give nearly
   every noise image one class: --synthetic k, k the first image of a
   second class), the 11 batched ones at --image_batch 4 in float32,
   eclip, game and m2ib in bf16, and on CLIP32 eclip image by image and
   lrp at B=4 (each battery blur 1, reveal 5, quickshift 0); the sanity
   driver (eclip, rollout at B=4 in bf16), the seg driver (eclip,
   maskclip at B=4), the image finder, the 9-name CLIP panel (no name
   fails) and the sweep's CLIP16 rows (pert, sanity, seg x eclip,
   rollout); then the extended zoo (ROADMAP A13): each of the 15 names
   of xai_tpu's EXTENDED_ZOO outside the drivers' table (VGG16, VGG19,
   IV3 at 299 px, CONVNXT, swin_tiny / small / base, pvt_tiny / small /
   med, MAXVIT, VIT8, VIT_tiny, VIT_base, VIT_large) at full width with
   seeded random weights through the image finder's entry point on 200
   synthetic images at --batch_size 100, against ground truth made from
   the card's own classes, so that its mask must read 1,0,1,0,...; no
   kernel launches on these paths;
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
   the randomized weights bit-equal; xai_tpu's 32 px test ViT: every
   ViT name single and at B=3 within 1e-4 relative in float32
   (bidirectional at start_layer 1 too), the batched battery within
   2e-3, bf16 rollout against float32 Spearman rho > 0.95; its widths at
   48 px as --model TINY_VIT: the randomized weights bit-equal, the
   sanity CSV and seg TXT (rollout, t_attr, t_attr at B=2) within 2e-3;
   and, on the test ViT, TIS with shared centroids, ViT-CX with shared
   noise (labels equal, or a merge at the threshold), MDA (picks equal up
   to a first flipped pick that is a rounding-level tie), 3 epochs of
   refine_attribution within 1e-4, the classic metrics within 1e-5 and
   PIC's areas (where PIL's WebP encoder imports) within 1e-5; and on
   xai_tpu's tiny test CLIP at 32 px every CLIP name single and at B=3
   (m2ib with shared noise, rise with shared masks) within 1e-4 relative
   in float32, and its driver-sized widths at 48 px with the real prompt
   table: the randomized weights bit-equal, the rebuilt text table within
   1e-5 and the sanity CSV (eclip, rollout, rollout at B=2) within 2e-3;
   the zoo's families at small widths (a VGG11-shaped VGG, Inception-v3
   at 75 px, ConvNeXt, Swin with shifted windows, PVT with sr > 1 in the
   cls stage, MaxViT in both forms) in float32, logits and every tap
   within 1e-4, and each of the 15 full-width names on 2 images, logits
   within 1e-3 of max |logit| and top-1 equal unless the CPU's top two
   lie within that bound;
6. time the warm paths that no benchmark cell measures (the cells
   r101_ig_b1, r101_ig_b4 and vit16_rollout_b4 time R101 IG-50 and its
   battery image by image and at B=4, and VIT16 rollout and its battery
   at B=4): one warm LIME attribution of R101, split by stage with CUDA
   events; then R101 at B=4: batched IG-50 in bf16 (with its Spearman
   rho against float32), LIG, IDG, IDGI and SG in float32 and in bf16,
   per image, with CUDA events; then each of the rest of the family warm
   on R101, image by image and at B=4 (shap in bf16 too), with CUDA
   events and peak memory; sanity-ig and seg-ig per image, split into
   attribution and host metrics, and the image finder's images a second
   at --batch_size 100; then VIT16: each ViT name's s/image image by
   image and at B=4 in float32 and bf16 with peak memory, the battery
   image by image, sanity-rollout and seg-rollout per image, and the
   image finder's images a second;
   and TIS, VIT_CX, MDA and MDA_dense image by image (TIS and VIT_CX in
   bf16 too) and VIT_CX at B=4 in float32 and bf16, with peak memory;
   then CLIP16: the text table's build, each CLIP name's s/image image by
   image and the 11 batched at B=4 in float32 and bf16 with peak memory
   and bf16's Spearman rho against float32 (> 0.95), the battery image by
   image and at B=4, and CLIP32's battery; each zoo name's forward at
   B=100 (images/s with CUDA events, TFLOP/s from torch's flop counter,
   peak memory) and its finder's images/s end to end (a {"zoo": [...]}
   line);
7. multi-process runs (ROADMAP A14), after phase 4's paths and on its
   files: two processes on the one card, joined by gloo on localhost
   (parallel/multi_host.py), each driving with --shard_images
   evaluate_perturbation, evaluate_sanity and evaluate_imagenet_seg on
   R101 ig at --synthetic 2 (phase 4's flags), imagenet_seg_eval on
   TINY_R grad at --synthetic 4 --acc_cutoff 0, and the sweep of TINY_R
   grad and ig into one shared directory; each prints the card count,
   its stripe, what each driver returned and its launches.  Process 0's
   CSVs and TXTs must be within 1e-4 of the single-process runs of the
   same flags, runtime rows aside; process 1 writes no result file; both
   return the same scores; the shared manifest holds both sweep runs ok;
   the two processes' launches add up to the single-process run's (blur
   1, reveal 5 a scored R101 image, quickshift 0).  A worker that exits
   non-zero or outlasts its timeout fails the run;
8. the profiler: evaluate_perturbation's main with --profile_dir on one
   synthetic image of R101 ig, VIT16 rollout and CLIP16 eclip: each
   Chrome trace must hold device kernels, blur and reveal among them,
   and its CSV must be within 1e-4 of the same run unprofiled; prints
   the top kernels by summed device time, the busy share of the traced
   window and of the kernels' span, and a {"profiles": [...]} line;
9. the in-process mesh (ROADMAP A15), after phase 4's paths and on its
   files, at full width: its meshes are the visible cards in turn when
   there are two or more, else a virtual mesh that repeats cuda:0 (the
   phase prints which, and torch.cuda.device_count()).  On two or more
   cards, each kernel launched on cuda:1 must leave the current device
   as it was; on one card the line says this could not be checked.
   VIT16 with seeded random weights: the tensor-parallel model over two
   ranks at B=4, logits within 1e-4 of max |logit| of the whole model;
   the eval step on a 2x2 mesh with vit_param_spec at B=8, both means
   within 1e-5 of the one-device step; one float32 MAS-calibration train
   step at B=4 on the 2x2 mesh, from a bias that folds |.| inside the
   attributions' channel sums (from init_fn's calibration the scale's
   gradient is a rounding residue that Adam's first step magnifies),
   loss, scale and bias within 1e-4 of one device and both gradients
   (Adam's first moment) within 1e-3 of their size; the tensor-parallel
   battery at B=2 over the 2x2 mesh (blur 2, reveal 10) within 2e-3 of
   the one-device battery.  R101: the battery at B=6 over a 4x1 mesh,
   shards 2/2/1/1 (blur 4, reveal 20), within 2e-3 of one device, and
   evaluate_perturbation --attr_func ig --image_batch 4 --synthetic 4
   --image_count 4000 with its battery_mesh standing for that mesh
   (blur 4, reveal 20), its CSV within 2e-3
   of phase 4's one-card file.  Prints each warm step's time with CUDA
   events, mesh against one device (on a virtual mesh: overhead, not
   scaling).  Every earlier phase runs the driver's own mesh, which on a
   one-card host is 1x1: the whole batch on the card, as before;
10. the library entry point (ROADMAP A16): an RGB JPEG of 400x300 and an
   L-mode PNG written from np.random.RandomState(0); load_and_preprocess
   on the card must give the JPEG as a normalized [1, 224, 224, 3] input
   and refuse the PNG with None; then the three walkthroughs at full
   width with seeded random weights on the JPEG, each through its
   module's main as `python -m` runs it, in a process of its own:
   xai_tpu_torch.examples.cnn_example on R50 at 224 px (grad, IG-50,
   LIG-50, IDG-50, each scored by the battery: blur 4, reveal 20),
   vit_example on VIT16 with --with_mda (five attention maps, MDA at 196
   patches from the bidirectional prior: blur 2, reveal 18 for its
   rescoring) and clip_example on CLIP16 (four maps, no kernel); each
   must print finite numbers, and its seconds and the card's peak memory
   are printed beside the card line.  Phase 5 holds each walkthrough's
   run card vs CPU on small models: TINY_R at 32 px (saliencies 1e-4,
   battery scores 2e-3), a 5-block test ViT at 32 px (five maps 1e-4, MDA
   at 16 patches 1e-4 where its picks agree, else a first flipped pick
   that is a rounding-level tie) and the tiny CLIP (1e-4).

Every phase's seconds are printed as it ends, and all of them in a
{"phases_s": {...}} line.  Prints the card line, a {"kernels": [...]}
JSON line, and last {"ok": true, "device": {...}}.  Imports nothing of
JAX or xai_tpu.
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
    from xai_tpu_torch.kernels.bn_act import bn_act
    from xai_tpu_torch.kernels.layernorm import layernorm
    from xai_tpu_torch.kernels.quickshift import quickshift_parents
    from xai_tpu_torch.kernels.reveal import reveal_batch
    return {"blur_planes": blur_planes, "reveal_batch": reveal_batch,
            "quickshift_parents": quickshift_parents, "bn_act": bn_act,
            "layernorm": layernorm}


class FusedPasses:
    """The launches of the fused passes that a path's forwards should
    make, counted by a global forward pre-hook at each module's input,
    the input that the model dispatches on, where no autograd graph is
    recorded.  ``bn_act``: one for a ResNet's stem and three for a
    bottleneck (``models/resnet.py``), where the input is a contiguous
    CUDA float32 tensor and the module's activation is ``F.relu``: R101
    100 a fused forward.  A channels-last view (LIME's samples, for one:
    a permuted NHWC stack) keeps the stem's separate ops, and its blocks
    fuse only where the stem's output comes out contiguous.
    ``layernorm``: one a ``models/common.py LayerNorm`` call whose
    operands the kernel takes (``kernels/layernorm.py fits``): ViT-B/16
    25 a forward, Swin-B 53.  Each path's expected counts are
    :meth:`want`, zeroed with the kernel counters by :meth:`zero`: 0
    where no such model runs and in the forwards that record a graph."""

    def __init__(self):
        import threading

        import torch
        import torch.nn.functional as F
        from torch.nn.modules.module import register_module_forward_pre_hook

        from xai_tpu_torch.kernels.layernorm import fits
        from xai_tpu_torch.models.common import LayerNorm
        from xai_tpu_torch.models.resnet import Bottleneck, ResNet

        self.counts = dict.fromkeys(FUSED, 0)
        # a mesh battery's shards run in threads
        self._lock = threading.Lock()

        def pre_hook(module, args):
            if not args or torch.is_grad_enabled():
                return
            x = args[0]
            if isinstance(module, LayerNorm):
                if fits(x, module.scale, module.bias):
                    self._add("layernorm", 1)
                return
            passes = (1 if isinstance(module, ResNet) else
                      3 if isinstance(module, Bottleneck) else 0)
            if (passes and module.relu is F.relu and x.is_cuda
                    and x.dtype == torch.float32 and x.is_contiguous()):
                self._add("bn_act", passes)

        register_module_forward_pre_hook(pre_hook)

    def _add(self, name: str, n: int) -> None:
        with self._lock:
            self.counts[name] += n

    def zero(self) -> None:
        with self._lock:
            self.counts = dict.fromkeys(FUSED, 0)

    def want(self) -> dict:
        with self._lock:
            return dict(self.counts)


# the kernels whose launches FusedPasses expects from the forwards
FUSED = ("bn_act", "layernorm")
_FUSED_PASSES = []


def fused_passes() -> FusedPasses:
    """This process's one FusedPasses, its hook installed at the first
    call."""
    if not _FUSED_PASSES:
        _FUSED_PASSES.append(FusedPasses())
    return _FUSED_PASSES[0]


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
    # the fused widths of MDA's adaptive blur (35, 39, ..., 63, which the
    # confident VIT16 copy and the VIT32 sweep reach), and 61: the tiles
    # of klen 61 and 63 opt into more than 48 KiB of shared memory
    by_klen = {}
    for klen in sorted(set(range(35, 64, 4)) | {61}):
        before = kblur.blur_planes.launches
        got = kblur.blur_planes(planes, klen, float(klen))
        if kblur.blur_planes.launches - before != 1:
            fail(f"blur klen {klen} launched "
                 f"{kblur.blur_planes.launches - before} kernels, not 1")
        want = kblur.blur_planes_plain(planes, klen, float(klen))
        torch.cuda.synchronize()
        e = float((got - want).abs().max())
        by_klen[klen] = f"{e:.3g}"
        if not (e < BLUR_TOL and bool(torch.isfinite(got).all())):
            fail(f"blur kernel at klen {klen} disagrees with its plain "
                 f"version: {e}")
        err = max(err, e)
    print(f"blur_planes {list(planes.shape)} fused, MDA's widths: max "
          f"|kernel - plain| by klen {json.dumps(by_klen)} (tolerance "
          f"{BLUR_TOL})")
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

    # --- reveal: one image (reveal_chunk, the B = 1 view): S=45 at 224 px,
    # ragged S=1, and a plane size that is not a multiple of 4 (the
    # scalar variant); a batch (reveal_batch): [4, 45, 3, 224, 224], the
    # battery's launches (its three passes as 3B images: starts
    # [blurred; x; x], finishes [x; 0; 0], flips [desc; desc; asc]) at
    # [3, 45, 3, 224, 224] (image by image) and [12, 45, 3, 224, 224]
    # (--image_batch 4), a ragged B=3, S=7 at 3x15x13 (scalar), and B=1
    # against reveal_chunk ---
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

    def passes(x, blurred, desc, asc):
        zeros = torch.zeros_like(x)
        return (torch.cat([blurred, x, x]), torch.cat([x, zeros, zeros]),
                torch.cat([desc, desc, asc]))

    battery3 = passes(planes[None], finish[None], flip[None],
                      flips(1, 224, 224))
    battery12 = passes(starts4, finishes4, flips4, flips(4, 224, 224))
    batch_cases = [
        (starts4, finishes4, flips4, steps45),
        (*battery3, steps45),
        (*battery12, steps45),
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
          "the battery's [3, 45, 3, 224, 224] and [12, 45, 3, 224, 224], "
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
    # the battery's launches: 5 a battery of one image, or of four
    for b, case in ((3, battery3), (12, battery12)):
        rows[-1].update({
            f"ms_b{b}": device_ms(torch, lambda: kreveal.reveal_batch(
                *case, steps45)),
            f"plain_ms_b{b}": device_ms(
                torch, lambda: kreveal.reveal_batch_plain(*case, steps45)),
            f"bound_ms_b{b}": reveal_bound_ms(s, c, h, w, b=b)})
    for b in (4, 3, 12):
        print(f"reveal_batch [{b}, 45, 3, 224, 224]: kernel "
              f"{rows[-1][f'ms_b{b}'] * 1e3:.2f} us, torch.where over the "
              f"batch {rows[-1][f'plain_ms_b{b}'] * 1e3:.2f} us, bound "
              f"{rows[-1][f'bound_ms_b{b}'] * 1e3:.2f} us (bytes, "
              f"{rows[-1][f'bound_ms_b{b}'] / rows[-1][f'ms_b{b}']:.1%})")
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


def special_values(torch, t, gen, share: float = 0.01):
    """``t`` with about ``share`` of its elements set, each at random, to
    NaN, +0, -0, +inf or -inf (in place; returned)."""
    flat = t.view(-1)
    picks = torch.rand(flat.shape, device=t.device, generator=gen) < share
    which = torch.randint(0, 5, flat.shape, device=t.device, generator=gen)
    values = torch.tensor([math.nan, 0.0, -0.0, math.inf, -math.inf],
                          device=t.device)
    flat[picks] = values[which[picks]]
    return t


def bits_equal(torch, got, want) -> bool:
    """Bit for bit: NaN equal to NaN, +0 unequal to -0."""
    return (got.shape == want.shape and got.dtype == want.dtype
            and torch.equal(got.view(torch.int32), want.view(torch.int32)))


def check_bn_act(torch, dev):
    """Phase 3, the ResNet epilogue: bit-exact against its plain version
    in its three forms at every R101 plane size, ragged ones and a
    misaligned view, NaN, infinities and signed zeros among the inputs; a
    whole R101 forward on the fused path equal to the plain path, 100
    launches; then each distinct epilogue of a 180-row forward (the
    battery's at --image_batch 4) timed beside its bytes bound, the plain
    version and the fewest PyTorch calls (addcmul, add_, relu_), and of a
    135-row one (image by image) beside its bound, summed over the
    forward's 100 passes.  Inputs rotate through copies that
    together exceed the 50 MB L2, so no pass finds its input there."""
    import copy
    import itertools

    import torch.nn.functional as F

    from xai_tpu_torch.kernels import bn_act as kb
    from xai_tpu_torch.kernels.bounds import bn_act_bound_ms
    from xai_tpu_torch.models import resnet

    gen = torch.Generator(dev).manual_seed(3)

    def operands(n, c, h, w, residual, residual_bn, special=True):
        def rand(*shape):
            t = torch.randn(*shape, device=dev, generator=gen)
            return special_values(torch, t, gen) if special else t
        args = [rand(n, c, h, w), rand(c), rand(c)]
        if residual:
            args.append(rand(n, c, h, w))
        if residual_bn:
            args += [rand(c), rand(c)]
        return args

    forms = [(False, False), (True, False), (True, True)]
    # R101's planes (7x7 straddles channels within a quad), then the
    # scalar variant's: an odd element count, a plane under 4 elements
    cases = [(3, 24, hw, hw) for hw in (112, 56, 28, 14, 7)] + [
        (3, 24, 13, 11), (2, 5, 13, 11), (2, 3, 7, 7), (1, 3, 1, 3)]
    for n, c, h, w in cases:
        for form in forms:
            args = operands(n, c, h, w, *form)
            before = kb.bn_act.launches
            got = kb.bn_act(*args)
            if kb.bn_act.launches - before != 1:
                fail("bn_act launched more or fewer than one kernel")
            if not bits_equal(torch, got, kb.bn_act_plain(*args)):
                fail(f"bn_act disagrees with its plain version at "
                     f"{[n, c, h, w]}, residual / its BN {form}")
    # a contiguous view 4 bytes off a 16-byte boundary: the scalar variant
    buf = torch.randn(3 * 24 * 56 * 56 + 1, device=dev, generator=gen)
    x = special_values(torch, buf[1:], gen).view(3, 24, 56, 56)
    for form in forms:
        args = [x] + operands(3, 24, 56, 56, *form)[1:]
        if not bits_equal(torch, kb.bn_act(*args), kb.bn_act_plain(*args)):
            fail(f"bn_act disagrees with its plain version on a "
                 f"misaligned view, residual / its BN {form}")
    print("bn_act: bit-exact against the plain version, forms relu, "
          "+ residual, + residual through its BN, at "
          + ", ".join(f"{list(s)}" for s in cases)
          + " and a misaligned [3, 24, 56, 56]; ~1 % NaN, +-0, +-inf")

    # a whole R101 forward, FoldedBN drawn at random: the fused path
    # against the plain one (the same F.relu arithmetic behind another
    # function object, so every module takes its plain code); each pass's
    # (c, h, w, residual, residual BN), in order, for the timings below
    model = resnet.make_model("resnet101").to(dev)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, resnet.FoldedBN):
                m.scale.copy_(1 + 0.2 * torch.randn(
                    m.scale.shape, device=dev, generator=gen))
                m.bias.copy_(0.2 * torch.randn(
                    m.bias.shape, device=dev, generator=gen))
    plain_model = resnet.set_relu(copy.deepcopy(model),
                                  lambda t: F.relu(t))
    x = torch.randn(8, 3, 224, 224, device=dev, generator=gen)
    passes = []

    def spy(y, scale, bias, *rest):
        passes.append((*y.shape[1:], len(rest) > 0, len(rest) > 1))
        return kb.bn_act(y, scale, bias, *rest)

    with torch.inference_mode():
        before = kb.bn_act.launches
        resnet.bn_act = spy
        try:
            got, got_taps = model(x, taps=True)
        finally:
            resnet.bn_act = kb.bn_act
        launches = kb.bn_act.launches - before
        want, want_taps = plain_model(x, taps=True)
        if kb.bn_act.launches - before != launches:
            fail("the plain R101 forward launched bn_act")
    if launches != 100 or len(passes) != 100:
        fail(f"a fused R101 forward launched bn_act {launches} times, "
             f"not 100")
    if not (bits_equal(torch, got, want) and all(
            bits_equal(torch, got_taps[k], want_taps[k]) for k in want_taps)):
        fail("the fused R101 forward differs from the plain one")
    del model, plain_model
    print("bn_act: a fused R101 forward at [8, 3, 224, 224] (100 "
          "launches) equals the plain forward, logits and every tap")

    def library(x, s, b, r=None, sd=None, bd=None):
        y = torch.addcmul(b[:, None, None], x, s[:, None, None])
        if r is not None:
            y.add_(r if sd is None else torch.addcmul(
                bd[:, None, None], r, sd[:, None, None]))
        return y.relu_()

    def timed(fn, sets):
        cycle = itertools.cycle(sets)
        return device_ms(torch, lambda: fn(*next(cycle)))

    by_shape = []
    totals = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
              "bound_ms": 0.0, "ms_135": 0.0, "bound_ms_135": 0.0}
    for shape in sorted(set(passes), key=passes.index):
        count = passes.count(shape)
        c, h, w, residual, residual_bn = shape
        row = {"shape": [180, c, h, w], "residual": residual,
               "residual_bn": residual_bn, "count": count}
        for n, key in ((180, ""), (135, "_135")):
            one = sum(t.numel() * 4 for t in operands(
                n, c, h, w, residual, residual_bn, special=False))
            sets = [operands(n, c, h, w, residual, residual_bn,
                             special=False)
                    for _ in range(max(1, -(-120_000_000 // one)))]
            if n == 180:
                if not bits_equal(torch, kb.bn_act(*sets[0]),
                                  kb.bn_act_plain(*sets[0])):
                    fail(f"bn_act disagrees with its plain version at "
                         f"{row['shape']}")
                row["plain_ms"] = timed(kb.bn_act_plain, sets)
                row["library_ms"] = timed(library, sets)
            row["ms" + key] = timed(kb.bn_act, sets)
            row["bound_ms" + key] = bn_act_bound_ms(n, c, h, w, residual,
                                                    residual_bn)
            del sets
        for k in totals:
            totals[k] += count * row[k]
        by_shape.append(row)
        print(f"bn_act {row['shape']} residual {residual} its BN "
              f"{residual_bn} (x{count}): kernel {row['ms'] * 1e3:.2f} us, "
              f"bound {row['bound_ms'] * 1e3:.2f} us "
              f"({row['bound_ms'] / row['ms']:.1%}), plain "
              f"{row['plain_ms'] * 1e3:.2f} us, library "
              f"{row['library_ms'] * 1e3:.2f} us")
    print(f"bn_act over one R101 forward's 100 passes at 180 rows: kernel "
          f"{totals['ms']:.4f} ms, bound {totals['bound_ms']:.4f} ms "
          f"({totals['bound_ms'] / totals['ms']:.1%}), plain "
          f"{totals['plain_ms']:.4f} ms, library "
          f"{totals['library_ms']:.4f} ms; at 135 rows kernel "
          f"{totals['ms_135']:.4f} ms, bound {totals['bound_ms_135']:.4f} "
          f"ms ({totals['bound_ms_135'] / totals['ms_135']:.1%})")
    return dict(name="bn_act", route="cuda",
                source="xai_tpu_torch/csrc/bn_act.cu",
                replaces="none: XLA fused these passes on the TPU",
                max_abs_err=0.0, bound_by="bytes", by_shape=by_shape,
                **totals)


# LayerNorm launches a forward under inference: ViT-B/16's 2 x 12 + 1;
# Swin-B's patch norm, 2 x 24 in its blocks, 3 patch mergings, the last
LN_VIT_B16 = 2 * 12 + 1
LN_SWIN_B = 1 + 2 * 24 + 3 + 1


def check_layernorm(torch, dev):
    """Phase 3, the fused LayerNorm: against its plain version and a
    float64 LayerNorm at every width the cells run (Swin-B's 128 to 2048,
    ViT-B/16's 768) at ragged row counts up to a 180-row ViT forward's
    35,460, and at widths whose quads leave lanes idle (64, 96, 320):
    centred rows within 4 float32 ulps of the plain version's largest
    |y| (with row offsets the fast variance cancels digits, and two
    orders of its sums differ by more); a width's rows, centred or not,
    no further from float64 than twice the plain version (root mean
    square over the width's row counts); rows with NaN or
    inf as the plain version gives them; one launch a call.  Then a
    ViT-B/16 and a Swin-B forward at [2, 3, 224, 224] under inference:
    one launch a LayerNorm, as many as FusedPasses counts (25 and 53),
    every token row fused, logits within 1e-4 of the largest of the same
    forward recording a graph (the separate ops).  Then each distinct
    LayerNorm of both models' 180-row forwards (the battery's at
    --image_batch 4) timed beside its bytes bound, the plain version and
    F.layer_norm (its two-pass variance is another formula: a yardstick
    of time only), summed over a forward's passes; Swin's patch norm on
    the strided NHWC view of the patch convolution, the separate ops
    against a contiguous copy and the kernel; and each model's whole
    180-row forward with the kernel and with the separate ops.  Inputs
    rotate through copies that together exceed the 50 MB L2."""
    import itertools

    import torch.nn.functional as F

    from xai_tpu_torch.kernels import layernorm as kl
    from xai_tpu_torch.kernels.bounds import layernorm_bound_ms
    from xai_tpu_torch.models import common, swin, vit
    from xai_tpu_torch.utils import trace

    gen = torch.Generator(dev).manual_seed(5)

    def operands(rows, c, offset=0.3):
        # a per-row spread and offset, as a residual stream has; at offset
        # 0 each row centred on 0 (in float64, then rounded)
        x = (torch.randn(rows, c, device=dev, generator=gen)
             * (0.5 + torch.rand(rows, 1, device=dev, generator=gen))
             + offset * torch.randn(rows, 1, device=dev, generator=gen))
        if not offset:
            x = (x.double() - x.double().mean(-1, keepdim=True)).float()
        return [x, 1 + 0.2 * torch.randn(c, device=dev, generator=gen),
                0.2 * torch.randn(c, device=dev, generator=gen)]

    def float64_ln(x, s, b, eps):
        x = x.double()
        mu = x.mean(-1, keepdim=True)
        var = ((x * x).mean(-1, keepdim=True) - mu * mu).clamp(min=0.0)
        return (x - mu) * (torch.rsqrt(var + eps) * s.double()) + b.double()

    widths = {c: (1, 31, 33, 35460) for c in (128, 256, 512, 768, 1024,
                                              2048)}
    widths.update({c: (1, 33, 1000) for c in (64, 96, 320)})
    # ulps from the plain version (centred rows; rows with an offset,
    # whose fast variance cancels digits, for the record); and a width's
    # error against float64 over its row counts together, root mean
    # square (the largest, for the record, is one draw of a few roundings
    # in the worst-conditioned row), over the plain version's
    worst = {"ulps": 0.0, "offset_ulps": 0.0, "rms_ratio": 0.0,
             "max_ratio": 0.0}
    bad = []
    for (c, counts), offset in itertools.product(widths.items(), (0.0, 0.3)):
        err = plain_err = sq = plain_sq = 0.0
        for rows in counts:
            x, sc, b = operands(rows, c, offset)
            before = kl.layernorm.launches
            got = kl.layernorm(x, sc, b, 1e-5)
            if kl.layernorm.launches - before != 1:
                fail("layernorm launched more or fewer than one kernel")
            want = kl.layernorm_plain(x, sc, b, 1e-5)
            exact = float64_ln(x, sc, b, 1e-5)
            top = want.abs().max().item()
            ulps = (got - want).abs().max().item() / 2.0 ** (
                math.floor(math.log2(top)) - 23)
            err = max(err, (got.double() - exact).abs().max().item())
            plain_err = max(plain_err,
                            (want.double() - exact).abs().max().item())
            sq += ((got.double() - exact) ** 2).sum().item()
            plain_sq += ((want.double() - exact) ** 2).sum().item()
            print(f"layernorm [{rows}, {c}], row offsets {offset}: "
                  f"{ulps:.2f} ulps from the plain version")
            if not (offset or ulps <= 4):
                bad.append(f"[{rows}, {c}]: {ulps:.2f} ulps")
            key = "offset_ulps" if offset else "ulps"
            worst[key] = max(worst[key], ulps)
        rms_ratio = math.sqrt(sq / plain_sq)
        print(f"layernorm width {c}, row offsets {offset}: error against "
              f"float64 {rms_ratio:.3f}x the plain version's (root mean "
              f"square), largest {err:.3e} against {plain_err:.3e}")
        if rms_ratio > 2:
            bad.append(f"width {c}, row offsets {offset}: error against "
                       f"float64 {rms_ratio:.3f}x the plain version's")
        worst["rms_ratio"] = max(worst["rms_ratio"], rms_ratio)
        worst["max_ratio"] = max(worst["max_ratio"], err / plain_err)
    if bad:
        fail("layernorm strays from the plain version or float64 at "
             + "; ".join(bad))
    x, sc, b = operands(40, 768)
    x[3, 7], x[9, 0], x[11] = math.nan, math.inf, 0.0
    got, want = kl.layernorm(x, sc, b, 1e-6), kl.layernorm_plain(x, sc, b,
                                                                1e-6)
    if not (torch.equal(torch.isnan(got), torch.isnan(want))
            and bool(torch.isnan(got[3]).all())
            and torch.equal(got[11], want[11])):
        fail("layernorm gives rows with NaN, inf or zeros otherwise than "
             "the plain version")
    print(f"layernorm: at widths {sorted(widths)}, centred rows within "
          f"{worst['ulps']:.2f} ulps of the plain version's largest |y| "
          f"(rows with offsets {worst['offset_ulps']:.2f}), error against "
          f"float64 at most {worst['rms_ratio']:.3f}x its (root mean "
          f"square; largest {worst['max_ratio']:.2f}x); NaN / inf / zero "
          f"rows as the plain version")

    # the two models' forwards: launches, counters, logits; each call's
    # (rows an image, width) for the timings below
    fused = fused_passes()
    calls = {}
    x = torch.randn(2, 3, 224, 224, device=dev, generator=gen)
    models = {"ViT-B/16": (lambda: vit.init_random(
        vit.make_model("vit_base_patch16_224"), 0), LN_VIT_B16),
        "Swin-B": (lambda: common.init_flax_default(
            swin.SwinTransformer(**swin.ARCHS["swin_base"]), 0), LN_SWIN_B)}
    for name, (make, norms) in models.items():
        model = make().to(dev)
        seen = calls[name] = []

        def spy(y, scale, bias, eps):
            seen.append((y.numel() // y.shape[-1] // 2, y.shape[-1]))
            return kl.layernorm(y, scale, bias, eps)

        fused.zero()
        before = kl.layernorm.launches
        counts = trace.counters()
        common.layernorm = spy
        try:
            with torch.inference_mode():
                got = model(x)
        finally:
            common.layernorm = kl.layernorm
        launches = kl.layernorm.launches - before
        after = trace.counters()
        rows, fused_rows = (after.get(k, 0) - counts.get(k, 0) for k in (
            "layernorm_rows", "layernorm_fused_rows"))
        want = model(x).detach()        # records a graph: the separate ops
        if kl.layernorm.launches - before != launches:
            fail(f"the {name} forward recording a graph launched layernorm")
        gap = ((got - want).abs().max() / want.abs().max()).item()
        if not (launches == norms == fused.want()["layernorm"]
                == len(seen) and rows == fused_rows > 0 and gap <= 1e-4):
            fail(f"a {name} forward under inference launched layernorm "
                 f"{launches} times (expected {norms}, FusedPasses "
                 f"{fused.want()['layernorm']}), fused {fused_rows} of "
                 f"{rows} rows, logits {gap:.3e} of the largest from the "
                 f"separate ops")
        print(f"layernorm: a {name} forward at [2, 3, 224, 224] under "
              f"inference launches {launches} (every LayerNorm, {rows} "
              f"rows, all fused), logits within {gap:.3e} of the largest "
              f"from the separate ops")
        del model, got, want

    def library(y, sc, b):
        return F.layer_norm(y, (y.shape[-1],), sc, b, 1e-5)

    def timed(fn, sets, launches=50):
        cycle = itertools.cycle(sets)
        return device_ms(torch, lambda: fn(*next(cycle)), launches)

    def sets_of(rows, c):
        one = rows * c * 4
        return [operands(rows, c)
                for _ in range(max(1, -(-120_000_000 // one)))]

    by_shape = []
    totals = {}
    for name, seen in calls.items():
        sums = dict.fromkeys(("ms", "plain_ms", "library_ms", "bound_ms"),
                             0.0)
        for per_image, c in sorted(set(seen), key=seen.index):
            count = seen.count((per_image, c))
            rows = 180 * per_image
            sets = sets_of(rows, c)
            row = {"model": name, "shape": [rows, c], "count": count,
                   "ms": timed(lambda *a: kl.layernorm(*a, 1e-5), sets),
                   "plain_ms": timed(
                       lambda *a: kl.layernorm_plain(*a, 1e-5), sets),
                   "library_ms": timed(library, sets),
                   "bound_ms": layernorm_bound_ms(rows, c)}
            del sets
            for k in sums:
                sums[k] += count * row[k]
            by_shape.append(row)
            print(f"layernorm {name} {row['shape']} (x{count}): kernel "
                  f"{row['ms'] * 1e3:.2f} us, bound "
                  f"{row['bound_ms'] * 1e3:.2f} us "
                  f"({row['bound_ms'] / row['ms']:.1%}), plain "
                  f"{row['plain_ms'] * 1e3:.2f} us, library "
                  f"{row['library_ms'] * 1e3:.2f} us")
        totals[name] = sums
        print(f"layernorm over one {name} 180-row forward's {len(seen)} "
              f"passes: kernel {sums['ms']:.4f} ms, bound "
              f"{sums['bound_ms']:.4f} ms "
              f"({sums['bound_ms'] / sums['ms']:.1%}), plain "
              f"{sums['plain_ms']:.4f} ms, library "
              f"{sums['library_ms']:.4f} ms")

    # Swin-B's patch norm: the patch convolution's NCHW output seen NHWC
    conv = torch.randn(180, 128, 56, 56, device=dev, generator=gen)
    view = conv.permute(0, 2, 3, 1)
    _, sc, b = operands(1, 128)
    patch = {"strided_plain_ms": device_ms(
        torch, lambda: kl.layernorm_plain(view, sc, b, 1e-5), 20),
        "copy_and_kernel_ms": device_ms(
        torch, lambda: kl.layernorm(view.contiguous(), sc, b, 1e-5), 20)}
    del conv, view
    print(f"layernorm: Swin-B's patch norm at 180 rows on the strided "
          f"view: separate ops {patch['strided_plain_ms']:.4f} ms, a "
          f"contiguous copy and the kernel "
          f"{patch['copy_and_kernel_ms']:.4f} ms")

    # each model's whole 180-row forward, the kernel against the separate
    # ops (the gate refused everywhere)
    forward_ms = {}
    gate = common._fused_layernorm
    for name, (make, _) in models.items():
        model = make().to(dev)
        batch = torch.randn(180, 3, 224, 224, device=dev, generator=gen)
        ms = {}
        with torch.inference_mode():
            for label in ("kernel", "separate ops", "separate ops",
                          "kernel"):
                common._fused_layernorm = (
                    gate if label == "kernel" else lambda *a: False)
                try:
                    ms.setdefault(label, []).append(device_ms(
                        torch, lambda: model(batch), launches=2, reps=3))
                finally:
                    common._fused_layernorm = gate
        forward_ms[name] = {k: statistics.mean(v) for k, v in ms.items()}
        print(f"{name} 180-row forward under inference: "
              f"{forward_ms[name]['kernel']:.2f} ms with the kernel, "
              f"{forward_ms[name]['separate ops']:.2f} ms with the "
              f"separate ops (two each, interleaved)")
        del model, batch
    vit_sums = totals["ViT-B/16"]
    return dict(name="layernorm", route="cuda",
                source="xai_tpu_torch/csrc/layernorm.cu",
                replaces="none: XLA fused LayerNorm on the TPU",
                worst=worst, bound_by="bytes", by_shape=by_shape,
                totals=totals, patch_norm=patch, forward_ms=forward_ms,
                **vit_sums)


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
# ceil(225 / 45) = 5 reveal chunks at 224 px (224 steps of 224 pixels,
# plus step 0), each one launch for all three passes
REVEAL_PER_BATTERY = math.ceil((224 * 224 // 224 + 1) / 45)
# bn_act launches a fused R101 forward: the stem and 3 x 33 bottlenecks
R101_EPILOGUES = 1 + 3 * (3 + 4 + 23 + 3)
# battery forwards a 224 px battery by its images (a data shard's), 5
# chunks each: one 135-row forward of the three passes at one image, 180
# + 90 rows at two, three of 180 (a pass each) at four
BATTERY_FORWARDS = {1: 5, 2: 10, 4: 15}


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
                  batch, model="R101", want=None, min_scored=1):
    """Phase 4: the flagship driver on ``model``, counters zeroed just
    before and read just after.  A per-image path scores image by image
    (the class quota may skip the second), at least ``min_scored``
    images; a batched path must score all its images in full batches.
    ``want``: expected_launches()'s function, for a path whose own choices
    set its launches (MDA's adaptive blur and rescoring); the launches
    must then equal what it returns."""
    from xai_tpu_torch.parallel.mesh import shard_slices
    from xai_tpu_torch.runners import evaluate_perturbation as ep
    from xai_tpu_torch.utils import trace

    out_dir = os.path.join(out_dir, label)
    attr_func = flags[flags.index("--attr_func") + 1]
    args = ep.build_parser().parse_args(
        ["--model", model, *flags, "--synthetic", str(n_images),
         "--image_count", str(count), "--image_batch", str(batch),
         "--output_dir", out_dir, "--verbose"])
    torch.cuda.reset_peak_memory_stats(dev)
    log = io.StringIO()
    wrappers = kernel_wrappers()
    for fn in wrappers.values():
        fn.launches = 0
    fused = fused_passes()
    fused.zero()
    forwards = trace.counters().get("battery_forwards", 0)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(log):
        ep.evaluate_perturbation(args, device=dev)
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in wrappers.items()}
    forwards = trace.counters().get("battery_forwards", 0) - forwards
    peak = torch.cuda.max_memory_allocated(dev)
    print(log.getvalue(), end="")
    # --verbose prints one line per scored image ("[i/n] ..." image by
    # image, "[batch] ..." in a batch)
    scored = sum(line.startswith("[") for line in log.getvalue().splitlines())
    if scored < min_scored or (batch > 1 and scored != n_images):
        fail(f"the {label} main path scored {scored} of {n_images} images")

    with open(os.path.join(out_dir, model,
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
    # which blur too) and 5 reveal launches; LIME segments its image(s)
    # in one quickshift launch
    flushes = scored // batch
    # a flush runs one battery a data shard of the driver's mesh (one card:
    # one shard)
    batteries = flushes * (ep.battery_mesh(dev, batch).shape["data"]
                           if batch > 1 else 1)
    if want is not None:
        want = dict(want(), **fused.want())
        if launches != want:
            fail(f"the {label} main path launched {launches}, expected "
                 f"{want}")
    if batch == 1:
        ok_blur = launches["blur_planes"] >= scored
    else:
        ok_blur = launches["blur_planes"] == batteries
    want_reveal = (REVEAL_PER_BATTERY * batteries if want is None
                   else want["reveal_batch"])
    want_qs = flushes if attr_func == "lime" else 0
    if not ok_blur:
        fail(f"blur kernel launched {launches['blur_planes']} times on the "
             f"{label} main path ({batteries} batteries)")
    if launches["reveal_batch"] != want_reveal:
        fail(f"reveal kernel launched {launches['reveal_batch']} times on "
             f"the {label} main path, expected {want_reveal}")
    # a battery's reveal launch feeds the model whole passes
    shards = ([1] if batch == 1 else
              [sl.stop - sl.start for _, sl in
               shard_slices(ep.battery_mesh(dev, batch), batch)])
    if not set(shards) <= set(BATTERY_FORWARDS):
        fail(f"the {label} main path's data shards {shards} hold an image "
             f"count of no known battery forward count")
    want_forwards = flushes * sum(BATTERY_FORWARDS[n] for n in shards)
    if want is None and forwards != want_forwards:
        fail(f"the {label} main path's batteries ran {forwards} forwards, "
             f"expected {want_forwards}")
    if launches["quickshift_parents"] != want_qs:
        fail(f"quickshift kernel launched "
             f"{launches['quickshift_parents']} times on the {label} "
             f"main path, expected {want_qs}")
    # every battery forward is a fused R101 forward
    expected = fused.want()
    if launches["bn_act"] != expected["bn_act"] or (
            model == "R101" and launches["bn_act"]
            < R101_EPILOGUES * forwards):
        fail(f"bn_act launched {launches['bn_act']} times on the {label} "
             f"main path, expected {expected['bn_act']} (its forwards), "
             f"at least {R101_EPILOGUES} a battery forward on R101 "
             f"({forwards})")
    if launches["layernorm"] != expected["layernorm"]:
        fail(f"layernorm launched {launches['layernorm']} times on the "
             f"{label} main path, expected {expected['layernorm']} (its "
             f"forwards' LayerNorms)")
    print(f"{label} main path: {scored} of {n_images} images scored in "
          f"{flushes} {'flushes of ' + str(batch) if batch > 1 else 'runs'}"
          f", total {total:.3f} s, attribution "
          f"{rows['Attr Avg Runtime']:.3f} s/image (driver CSV, first "
          f"batch cold), peak memory {peak / 2**30:.2f} GiB, launches "
          f"{json.dumps(launches)}, battery forwards {forwards}")
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
    """Phase 6: one warm LIME of R101, split into its stages with CUDA
    events (IG-50 and the battery image by image are the cell
    r101_ig_b1's).  Returns the R101 bundle."""
    import numpy as np

    from xai_tpu_torch.methods import lime as tl
    from xai_tpu_torch.runners.common import build_bundle

    bundle = build_bundle("R101", device=dev)
    img = np.random.RandomState(0).rand(224, 224, 3).astype(np.float32)

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
    return bundle


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


def time_warm_batch(torch, dev, card, bundle):
    """Phase 6, batched: R101 at --image_batch 4, each IG-family method in
    float32 and in bf16, timed with CUDA events on a second, warm call.
    IG-50 in float32 and its battery at B=4 are the cell r101_ig_b4's;
    that map is made once here, untimed, for bf16's Spearman rho."""
    import numpy as np

    from xai_tpu_torch.methods.batch import batch_attribution
    from xai_tpu_torch.ops.stats import spearman_np
    from xai_tpu_torch.runners.common import normalize_input

    b = 4
    imgs = np.random.RandomState(0).rand(b, 224, 224, 3).astype(np.float32)
    xs = torch.stack([normalize_input(im, "cnn", dev) for im in imgs])
    targets = [1, 2, 3, 4]
    methods = ("ig", "lig", "idg", "idgi", "sg")

    def attribute(m, dtype):
        return batch_attribution(
            "cnn", m, bundle, xs, imgs, targets,
            [torch.Generator(dev).manual_seed(i) for i in range(b)],
            dtype=dtype)

    sals = {("ig", "f32"): attribute("ig", None)}
    per = {}
    for dname, dtype in (("f32", None), ("bf16", torch.bfloat16)):
        for m in methods:
            if (m, dname) in sals:
                continue
            torch.cuda.reset_peak_memory_stats(dev)
            for _ in range(2):               # the first call warms up
                sals[m, dname], sec = _event_s(
                    torch, lambda: attribute(m, dtype))
            per[m, dname] = sec / b
            peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
            print(f"R101 warm batched {m} {dname}: {per[m, dname]:.4f} "
                  f"s/image at B={b} (peak memory {peak:.2f} GiB)")
    for (m, dname), sal in sals.items():
        if not np.isfinite(sal).all():
            fail(f"batched R101 {m} {dname}: non-finite saliency")
    # zero-bias random weights give a zero gradient at the black image, so
    # a LIG cut at its first step leaves a constant map: rho is undefined
    with np.errstate(invalid="ignore"):
        rho = {m: min(spearman_np(f, h) for f, h in zip(sals[m, "f32"],
                                                        sals[m, "bf16"]))
               for m in methods}
    print(f"R101 warm at B={b}, s/image (CUDA events): "
          + ", ".join(f"{m} {dname} {sec:.4f}"
                      for (m, dname), sec in per.items())
          + f" on {card}")
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
    have["webp"] = False
    if have["PIL"]:
        from PIL import features
        have["webp"] = bool(features.check("webp"))
    skipped = [f"{what} (needs {n})" for n, what in
               (("h5py", "the --save_maps paths"),
                ("matplotlib", "the qualitative grid's PNG"),
                ("webp", "the PIC check"))
               if not have[n]]
    print("optional packages: " + ", ".join(
        f"{'PIL WebP encoder' if n == 'webp' else n} "
        f"{'imports' if ok else 'missing'}" for n, ok in have.items())
        + ("; covered by the CPU tests only: " + ", ".join(skipped)
           if skipped else "; every driven phase runs"))
    return have


NO_LAUNCHES = {"blur_planes": 0, "reveal_batch": 0, "quickshift_parents": 0,
               "bn_act": 0, "layernorm": 0}


def run_path(torch, label, fn, want):
    """Drive one path, every kernel counter zeroed just before and read
    just after; fails unless each kernel launched as ``want`` says (a
    dict, or a function that returns it once the path has run, for the
    counts that the path's own choices set); bn_act's and layernorm's
    expected counts are FusedPasses'.  Returns (fn's result, the
    launches)."""
    wrappers = kernel_wrappers()
    for w in wrappers.values():
        w.launches = 0
    fused = fused_passes()
    fused.zero()
    log = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(log):
        result = fn()
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    launches = {n: w.launches for n, w in wrappers.items()}
    print(log.getvalue(), end="")
    if callable(want):
        want = want()
    want = dict(want, **fused.want())
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


def check_constant_maps(label, scores: dict, pairs: list,
                        n_images: int) -> None:
    """A sanity driver's scores, where a map may be constant.  R101's
    randomized model (every convolution redrawn, the folded batch norms
    left) puts its logits in the millions: every LIME sample's softmax is
    one-hot at the same class, the ridge finds no positive segment and the
    map is constant; a ViT with every parameter N(0, 1) saturates its
    attention.  xai_tpu's ``evaluate`` gives a constant map SSIM on its
    zeroed map but NaN Spearman and HOG Spearman (the Spearman of a
    constant vector), and so does the port.  ``pairs``: (trained,
    randomized) map of each image.  SSIM must be finite; SPR and HOG are
    NaN exactly where an image has a constant map, else finite."""
    import numpy as np

    constant = [float(np.ptp(a)) == 0 or float(np.ptp(b)) == 0
                for a, b in pairs]
    print(f"{label} scores:", json.dumps(scores))
    nan = [k for k, v in scores.items() if not math.isfinite(v)]
    want = ["SPR", "HOG"] if any(constant) else []
    if (list(scores) != list(SANITY_KEYS) or nan != want
            or len(pairs) != n_images):
        fail(f"{label}: scores {scores}, constant maps {constant}")
    print(f"{label}: {sum(constant)} of {len(pairs)} images have a "
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
            check_constant_maps(label, scores,
                                list(zip(maps[0::2], maps[1::2])), 2)
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
    # quota at --image_count 2) and launches blur once and reveal 5 times
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


# --- the ViT family (ROADMAP A10 slice 1) ---

VIT_NAMES = ("attn", "grad", "cam_attn", "n_rollout", "rollout", "t_attn",
             "attn_ig", "attn_attr", "bi_attn", "InFlow", "t_attr")
VIT_BF16 = ("rollout", "t_attr", "bi_attn")
# the flagship driver on VIT16 (and VIT32): every name image by image and
# at B=4 in float32, three in bf16; (label, flags, images, --image_count,
# --image_batch, model) as MAIN_PATHS
VIT_PATHS = (
    [(f"vit16_{n}", ["--attr_func", n], 2, 2, 1, "VIT16")
     for n in VIT_NAMES]
    + [(f"vit16_{n}_b4", ["--attr_func", n], 4, 4000, 4, "VIT16")
       for n in VIT_NAMES]
    + [(f"vit16_{n}_b4_bf16", ["--attr_func", n, "--attr_dtype", "bf16"], 4,
        4000, 4, "VIT16") for n in VIT_BF16]
    + [("vit32_rollout", ["--attr_func", "rollout"], 2, 2, 1, "VIT32"),
       ("vit32_t_attr_b4", ["--attr_func", "t_attr"], 4, 4000, 4, "VIT32")])
# xai_tpu's test ViT (tests/test_batch_attr.py), and its widths at 48 px
# for the drivers (at 32 px HOG has no 3 x 3 block of 16 px cells)
VIT32PX = dict(patch=8, embed_dim=32, depth=2, num_heads=4, mlp_ratio=2.0,
               num_classes=16, img_hw=32)


def model_classes(torch, dev, model: str, n: int) -> list:
    """``model``'s class (seeded random weights, as the drivers build
    them) of each of the first ``n`` images of the --synthetic stream."""
    from xai_tpu_torch.data.imagenet import ImageNetValStream
    from xai_tpu_torch.runners.common import (build_bundle, normalize_input,
                                              predict_classes)

    bundle = build_bundle(model, device=dev)
    family = bundle.meta.family
    xs = torch.stack([normalize_input(it.trans_img, family, dev) for it in
                      ImageNetValStream("", bundle.meta.img_hw,
                                        synthetic=n)])
    classes = predict_classes(bundle, xs)
    print(f"{model} classes of the {n} synthetic images: {classes}")
    return classes


def _spy(module, name, store, pick=lambda out: out):
    """Wrap ``module.name`` so that each call's (picked) result is
    appended to ``store``; returns the original to put back."""
    original = getattr(module, name)

    def spy(*a, **k):
        out = original(*a, **k)
        store.append(pick(out))
        return out

    setattr(module, name, spy)
    return original


def drive_vit_driver_paths(torch, dev, out_dir, have) -> dict:
    """Phase 4, the other drivers on VIT16 at 224 px: sanity (rollout
    image by image, t_attr at B=4 in bf16), segmentation (rollout, t_attr
    at B=4), the image finder, the 11-name ViT panel (no name fails) and
    the sweep's ViT rows (pert, sanity, seg x rollout, t_attr); each
    through its entry point, with its launches.  Returns the launches by
    path."""
    import numpy as np

    from xai_tpu_torch.runners import evaluate_imagenet_seg as eg
    from xai_tpu_torch.runners import evaluate_sanity as es
    from xai_tpu_torch.runners import image_finder as fi
    from xai_tpu_torch.runners import qualitative_generation as qg
    from xai_tpu_torch.runners import sweep as sw

    by_path = {}
    for label, flags, n in (
            ("vit16_sanity_rollout", ["--attr_func", "rollout",
                                      "--synthetic", "2", "--image_count",
                                      "2"], 2),
            ("vit16_sanity_t_attr_b4_bf16", ["--attr_func", "t_attr",
                                             "--image_batch", "4",
                                             "--synthetic", "4",
                                             "--image_count", "4",
                                             "--attr_dtype", "bf16"], 4)):
        d = os.path.join(out_dir, label)
        args = es.build_parser().parse_args(
            ["--model", "VIT16", *flags, "--output_dir", d])
        maps = []        # per call: [B, H, W], trained then randomized
        get_attr = _spy(es, "get_attribution", maps, lambda m: m[None])
        batch_attr = _spy(es, "batch_attribute", maps, lambda out: out[0])
        try:
            _, by_path[label] = run_path(
                torch, label, lambda: es.evaluate_sanity(args, device=dev),
                NO_LAUNCHES)
        finally:
            es.get_attribution, es.batch_attribute = get_attr, batch_attr
        pairs = list(zip(np.concatenate(maps[0::2]),
                         np.concatenate(maps[1::2])))
        check_constant_maps(label, _read_sanity_csv(os.path.join(
            d, "VIT16", f"{args.attr_func}_{args.image_count}_images.csv")),
            pairs, n)
    for label, flags in (
            ("vit16_seg_rollout", ["--attr_func", "rollout", "--synthetic",
                                   "2"]),
            ("vit16_seg_t_attr_b4", ["--attr_func", "t_attr",
                                     "--image_batch", "4", "--synthetic",
                                     "4"])):
        d = os.path.join(out_dir, label)
        args = eg.build_parser().parse_args(
            ["--model", "VIT16", *flags, "--output_dir", d])
        _, by_path[label] = run_path(
            torch, label, lambda: eg.evaluate_imagenet_seg(args, device=dev),
            NO_LAUNCHES)
        _finite_scores(label, _read_seg_txt(os.path.join(
            d, "VIT16", f"{args.attr_func}_0_images")), SEG_LINES)

    classes = model_classes(torch, dev, "VIT16", 8)
    gt = os.path.join(out_dir, "vit16_ground_truth.txt")
    with open(gt, "w") as f:
        f.writelines(f"{c if i % 2 == 0 else (c + 1) % 1000}\n"
                     for i, c in enumerate(classes))
    args = fi.build_parser().parse_args(
        ["--model", "VIT16", "--synthetic", "8", "--batch_size", "4",
         "--ground_truth", gt, "--class_maps_dir",
         os.path.join(out_dir, "class_maps")])
    mask, by_path["vit16_image_finder"] = run_path(
        torch, "vit16_image_finder",
        lambda: fi.find_correctly_classified(args, device=dev), NO_LAUNCHES)
    if mask.tolist() != [1, 0] * 4:
        fail(f"VIT16 image_finder mask {mask.tolist()}")
    print(f"vit16_image_finder: mask {mask.tolist()} as constructed")

    panels = []
    panel_maps = _spy(qg, "panel_maps", panels)
    try:
        with expected_launches() as want:
            if have["matplotlib"]:
                args = qg.build_parser().parse_args(
                    ["--model", "VIT16", "--synthetic", "1", "--output_dir",
                     os.path.join(out_dir, "vit_qualitative")])
                written, by_path["vit16_qualitative"] = run_path(
                    torch, "vit16_qualitative",
                    lambda: qg.generate(args, device=dev), want)
                if list(written.values()) != [[]]:
                    fail(f"ViT qualitative grid: {written}")
            else:
                from xai_tpu_torch.data.imagenet import ImageNetValStream
                from xai_tpu_torch.runners.common import build_bundle

                bundle = build_bundle("VIT16", device=dev)
                item = next(iter(ImageNetValStream("", 224, synthetic=1)))
                _, by_path["vit16_qualitative"] = run_path(
                    torch, "vit16_qualitative", lambda: qg.panel_maps(
                        bundle, item, qg.VIT_PANEL, 0, dev), want)
            klens = list(want.klens)
    finally:
        qg.panel_maps = panel_maps
    maps, failed = panels[0]
    if (failed or sorted(maps) != sorted(qg.VIT_PANEL)
            or not all(np.isfinite(m).all() and m.shape == (224, 224)
                       for m in maps.values())):
        fail(f"ViT qualitative panel: failed {failed}, maps {sorted(maps)}")
    print(f"vit16_qualitative: all {len(maps)} ViT panel maps finite, none "
          f"failed (TIS, VIT_CX and MDA among them; MDA's blur stopped at "
          f"klen {klens})")

    d = os.path.join(out_dir, "vit_sweep")
    args = sw.build_parser().parse_args(
        ["--drivers", "pert,sanity,seg", "--models", "VIT16", "--methods",
         "rollout,t_attr", "--synthetic", "2", "--image_count", "2",
         "--output_dir", d])
    scored = 2 * len(set(classes[:2]))
    sanity_maps = []
    get_attr = _spy(es, "get_attribution", sanity_maps)
    try:
        records, by_path["vit16_sweep"] = run_path(
            torch, "vit16_sweep", lambda: sw.run_sweep(args, device=dev),
            dict(NO_LAUNCHES, blur_planes=scored,
                 reveal_batch=REVEAL_PER_BATTERY * scored))
    finally:
        es.get_attribution = get_attr
    with open(os.path.join(d, "sweep_manifest.jsonl")) as f:
        manifest = [json.loads(line) for line in f]
    if len(manifest) != 6 or records != manifest or not all(
            r["status"] == "ok" for r in manifest):
        fail(f"ViT sweep manifest: {manifest}")
    for r in manifest:
        if r["driver"] == "sanity":
            # the row's 4 maps: image 0 trained, randomized, image 1 ...
            m, sanity_maps[:4] = sanity_maps[:4], []
            check_constant_maps(f"vit16_sweep sanity/{r['attr_func']}",
                                r["scores"], list(zip(m[0::2], m[1::2])), 2)
        else:
            _finite_scores(f"vit16_sweep {r['driver']}/{r['attr_func']}",
                           r["scores"], list(r["scores"]))
    print("vit16_sweep: 6 manifest rows, all ok: " + ", ".join(
        f"{r['driver']}/{r['attr_func']} {r['seconds']} s" for r in manifest))
    return by_path


# --- the rest of the ViT family (ROADMAP A10 slice 2) and the library
# metrics under it (A12 slice 2) ---

SLICE2_NAMES = ("TIS", "VIT_CX", "MDA", "MDA_dense")
# the flagship driver on VIT16: each name at --synthetic 2 in float32 (two
# classes: both images score), TIS and VIT_CX on one image in bf16 too,
# VIT_CX at B=4 in float32 and bf16; (label, flags, images,
# --image_count, --image_batch, model) as MAIN_PATHS
SLICE2_PATHS = (
    [(f"vit16_{n}", ["--attr_func", n], 2, 2, 1, "VIT16")
     for n in SLICE2_NAMES]
    + [(f"vit16_{n}_bf16", ["--attr_func", n, "--attr_dtype", "bf16"], 1, 1,
        1, "VIT16") for n in ("TIS", "VIT_CX")]
    + [(f"vit16_VIT_CX_b4{d}", ["--attr_func", "VIT_CX"] + f, 4, 4000, 4,
        "VIT16") for d, f in (("", []), ("_bf16", ["--attr_dtype",
                                                    "bf16"]))])
# chip_smoke's confident copy of VIT16: one class's head bias raised, so
# that the blurred image keeps the target above 1 % and MDA's adaptive
# blur grows klen past 63 (the blur's two-launch width), as the confident
# real checkpoints do
CONFIDENT_CLASS, CONFIDENT_BIAS = 7, 10.0


def blur_width_launches(klen: int) -> int:
    from xai_tpu_torch.kernels.blur import MAX_FUSED_KLEN
    return 1 if klen <= MAX_FUSED_KLEN else 2


def mda_blur_launches(klen: int) -> int:
    """Blur launches of one MDA call whose adaptive blur stopped at
    ``klen``: one a tried klen (31, 35, ...), then the insertion search's
    start and the rescoring's substrate at the final klen."""
    return (sum(blur_width_launches(k) for k in range(31, klen + 1, 4))
            + 2 * blur_width_launches(klen))


@contextlib.contextmanager
def expected_launches():
    """Spies on the port's own choices that set how often a path launches
    each kernel: every ``batched_curves`` call (its chunks: one reveal
    launch each), every battery (one blur launch), every adaptive blur of
    MDA (the klen it stopped at) and every insertion prep of the MAS
    calibration (one blur at klen 31).  Yields a function that returns
    the launches the path should have made, with the klens in
    ``.klens``."""
    from xai_tpu_torch import registry
    from xai_tpu_torch.methods import mas_calibrate
    from xai_tpu_torch.metrics import curves

    chunks, batteries, klens, preps = [], [], [], []
    real_curves, real_prep = curves.batched_curves, mas_calibrate._prep

    def counted_curves(apply_fn, starts, finishes, flips, targets, n_steps,
                       chunk):
        chunks.append(math.ceil((n_steps + 1) / chunk))
        return real_curves(apply_fn, starts, finishes, flips, targets,
                           n_steps, chunk)

    def counted_prep(bundle, x, sal2d, mode, *a, **k):
        preps.append(mode != "del")
        return real_prep(bundle, x, sal2d, mode, *a, **k)

    originals = [
        (curves, "_battery", _spy(curves, "_battery", batteries)),
        (registry, "adaptive_blur",
         _spy(registry, "adaptive_blur", klens, lambda out: out[1])),
        (curves, "batched_curves", real_curves),
        (mas_calibrate, "_prep", real_prep)]
    curves.batched_curves = counted_curves
    mas_calibrate._prep = counted_prep

    def want():
        return {"blur_planes": len(batteries) + sum(preps) + sum(
                    mda_blur_launches(k) for k in klens),
                "reveal_batch": sum(chunks), "quickshift_parents": 0}

    want.klens = klens
    try:
        yield want
    finally:
        for module, name, original in originals:
            setattr(module, name, original)


def confident_vit16(build):
    """``build`` with VIT16's head bias of CONFIDENT_CLASS raised."""
    def wrapped(*a, **k):
        bundle = build(*a, **k)
        if bundle.meta.name == "VIT16":
            import torch
            with torch.no_grad():
                bundle.module.head.bias[CONFIDENT_CLASS] += CONFIDENT_BIAS
        return bundle
    return wrapped


def run_slice2_path(torch, dev, out_dir, label, flags, n_images, count,
                    batch, model, confident=False):
    """Phase 4, a slice-2 name through the flagship driver: the checks of
    run_main_path, with the launches that expected_launches() reads off
    the path (MDA's adaptive klens and rescoring among them), and the klen
    at which each MDA call stopped printed.  ``confident``: on VIT16's
    confident copy (confident_vit16), where the adaptive blur must pass
    klen 63."""
    from xai_tpu_torch.runners import evaluate_perturbation as ep

    build = ep.build_bundle
    if confident:
        ep.build_bundle = confident_vit16(build)
    try:
        with expected_launches() as want:
            launches = run_main_path(torch, dev, out_dir, label, flags,
                                     n_images, count, batch, model, want)
    finally:
        ep.build_bundle = build
    klens = want.klens
    if confident and not (klens and min(klens) > 63):
        fail(f"{label}: the confident model's adaptive blur stopped at "
             f"klen {klens}, not past 63")
    if klens:
        print(f"{label}: MDA's adaptive blur stopped at klen {klens}; "
              f"{sum(k > 63 for k in klens)} of its calls grew past 63, "
              f"where each blur takes two launches")
    return launches


def drive_slice2_driver_paths(torch, dev, out_dir) -> dict:
    """Phase 4, the slice-2 names through the other drivers on VIT16:
    MDA_dense through the seg driver, and the older seg driver
    imagenet_seg_eval with rollout and with Calibrate_Best_Possible (slic
    segments, 25 epochs of refine_attribution on rollout); then the
    sweep's slice-2 rows on VIT32 (pert, sanity, seg x TIS, VIT_CX, MDA,
    MDA_dense).  Launches by path."""
    from xai_tpu_torch.runners import evaluate_imagenet_seg as eg
    from xai_tpu_torch.runners import imagenet_seg_eval as se
    from xai_tpu_torch.runners import sweep as sw

    by_path = {}
    d = os.path.join(out_dir, "vit16_seg_MDA_dense")
    args = eg.build_parser().parse_args(
        ["--model", "VIT16", "--attr_func", "MDA_dense", "--synthetic", "1",
         "--output_dir", d])
    with expected_launches() as want:
        _, by_path["vit16_seg_MDA_dense"] = run_path(
            torch, "vit16_seg_MDA_dense",
            lambda: eg.evaluate_imagenet_seg(args, device=dev), want)
    _finite_scores("vit16_seg_MDA_dense", _read_seg_txt(os.path.join(
        d, "VIT16", "MDA_dense_0_images")), SEG_LINES)
    print(f"vit16_seg_MDA_dense: MDA's blur stopped at klen {want.klens}")

    for method in ("rollout", "Calibrate_Best_Possible"):
        label = f"vit16_imagenet_seg_eval_{method}"
        d = os.path.join(out_dir, label)
        # random weights are never 60 % confident: keep every image
        args = se.build_parser().parse_args(
            ["--model", "VIT16", "--method", method, "--synthetic", "2",
             "--acc_cutoff", "0", "--output_dir", d])
        with expected_launches() as want:
            _, by_path[label] = run_path(
                torch, label, lambda: se.run(args, device=dev), want)
        _finite_scores(label, _read_seg_txt(os.path.join(
            d, f"VIT16_{method}.txt")), SEG_LINES)

    d = os.path.join(out_dir, "vit32_slice2_sweep")
    args = sw.build_parser().parse_args(
        ["--drivers", "pert,sanity,seg", "--models", "VIT32", "--methods",
         ",".join(SLICE2_NAMES), "--synthetic", "1", "--image_count", "1",
         "--output_dir", d])
    with expected_launches() as want:
        records, by_path["vit32_slice2_sweep"] = run_path(
            torch, "vit32_slice2_sweep",
            lambda: sw.run_sweep(args, device=dev), want)
    rows = [(r["driver"], r["attr_func"]) for r in records]
    if rows != [(d, n) for d in ("pert", "sanity", "seg")
                for n in SLICE2_NAMES] or not all(r["status"] == "ok"
                                                  for r in records):
        fail(f"VIT32 slice-2 sweep: {records}")
    for r in records:
        if r["driver"] == "sanity":
            # the randomized ViT (every parameter N(0, 1)) saturates: a
            # constant or 0/0 map gives NaN scores, in xai_tpu too
            print(f"vit32_sweep sanity/{r['attr_func']} scores:",
                  json.dumps(r["scores"]))
            if list(r["scores"]) != list(SANITY_KEYS):
                fail(f"VIT32 sweep sanity/{r['attr_func']}: {r['scores']}")
        else:
            _finite_scores(f"vit32_sweep {r['driver']}/{r['attr_func']}",
                           r["scores"], list(r["scores"]))
    print("vit32_slice2_sweep: 12 manifest rows, all ok; MDA's blur stopped "
          f"at klen {want.klens}: " + ", ".join(
              f"{r['driver']}/{r['attr_func']} {r['seconds']} s"
              for r in records))
    return by_path


def tiny_vit(torch, device, img_hw: int = 32):
    """xai_tpu's test ViT (VIT32PX) at ``img_hw``, flax-scheme random
    weights of seed 0, on ``device``."""
    from xai_tpu_torch.models import vit as tvit
    from xai_tpu_torch.models.common import ModelBundle, ModelMeta

    cfg = tvit.ViTConfig(**dict(VIT32PX, img_hw=img_hw))
    module = tvit.init_random(tvit.VisionTransformer(cfg), seed=0)
    return ModelBundle(ModelMeta(name="tinyvit", family="vit",
                                 img_hw=img_hw, num_classes=16,
                                 num_patches=cfg.grid, batch_size=8,
                                 mean=(0.5,) * 3, std=(0.5,) * 3),
                       module.to(device))


def check_vit_reference(torch, dev):
    """Phase 5, the ViT family: xai_tpu's 32 px test ViT on the card
    against the same code on the CPU, in float32: every name single
    (through the registry) and at B=3 (batch_attribution) within 1e-4 of
    the CPU's largest value, bidirectional's head-weighted rollout at
    start_layer 1 too (at the driver's start_layer 4 a 2-block model
    weights no block: its maps are 0 on both devices); the batched
    battery within 2e-3; bf16 rollout against float32 on the card,
    Spearman rho > 0.95 per image (xai_tpu's contract)."""
    import numpy as np

    from xai_tpu_torch.methods import vit_explain as VE
    from xai_tpu_torch.methods.batch import batch_attribution
    from xai_tpu_torch.ops.stats import spearman_np
    from xai_tpu_torch.parallel.sharded_battery import sharded_battery_scores
    from xai_tpu_torch.registry import AttrContext, get_attribution
    from xai_tpu_torch.runners.common import default_blur

    cpu = torch.device("cpu")
    imgs = np.random.RandomState(2).randn(3, 32, 32, 3).astype(np.float32)
    targets = [3, 0, 11]
    runs = {}
    for name, d in (("cuda", dev), ("cpu", cpu)):
        bundle = tiny_vit(torch, d)
        xs = torch.as_tensor(imgs, device=d)
        out = {}
        for m in VIT_NAMES:
            out[m, "single"] = np.stack([get_attribution(
                "vit", m, AttrContext(bundle=bundle, x=x, trans_img=im,
                                      target=t, img_hw=32))
                for x, im, t in zip(xs, imgs, targets)])
            out[m, "b3"] = batch_attribution("vit", m, bundle, imgs, imgs,
                                             targets, None, img_hw=32)
        out["bi_attn_start1", "b3"] = VE.bidirectional(
            bundle, xs, targets, start_layer=1).cpu().numpy()
        runs[name] = (bundle, xs, out)
    worst = {}
    for key, want in runs["cpu"][2].items():
        got = runs["cuda"][2][key]
        scale = float(np.abs(want).max())
        err = float(np.abs(got - want).max()) / (scale or 1.0)
        worst[key] = err
        if not (np.isfinite(got).all() and err < 1e-4):
            fail(f"tiny ViT {key} on the card differs from the CPU: {err}")
    (b_gpu, x_gpu, _), (b_cpu, x_cpu, out_cpu) = runs["cuda"], runs["cpu"]
    sals = out_cpu["t_attr", "b3"]
    sg = sharded_battery_scores(b_gpu, x_gpu, sals, default_blur(), 45,
                                targets)
    sc = sharded_battery_scores(b_cpu, x_cpu, sals, default_blur(), 45,
                                targets)
    bat = max(abs(g[k] - c[k]) for g, c in zip(sg, sc) for k in c)
    if not bat < 2e-3 or not all(math.isfinite(v) for s in sg
                                 for v in s.values()):
        fail(f"tiny ViT batched battery on the card differs: {sg} vs {sc}")
    f32 = runs["cuda"][2]["rollout", "b3"]
    b16 = batch_attribution("vit", "rollout", b_gpu, imgs, imgs, targets,
                            None, img_hw=32, dtype=torch.bfloat16)
    rho = [spearman_np(a, b) for a, b in zip(f32, b16)]
    if not min(rho) > 0.95:
        fail(f"tiny ViT bf16 rollout against float32: rho {rho}")
    print("tiny ViT 32 px, card vs CPU, max |delta| / CPU max (< 1e-4): "
          + ", ".join(f"{m} {worst[m, 'single']:.3g} / B=3 "
                      f"{worst[m, 'b3']:.3g}" for m in VIT_NAMES)
          + f", bi_attn start_layer 1 B=3 {worst['bi_attn_start1', 'b3']:.3g}"
          f"; batched battery max |score delta| {bat:.3g} (< 2e-3); bf16 "
          f"rollout against float32 on the card, Spearman rho "
          f"{', '.join(f'{r:.4f}' for r in rho)} (> 0.95)")


# a greedy pick that flips card vs CPU must be a rounding-level tie: the
# two candidates' float32 responses within this of each other
MDA_PICK_TIE = 1e-5


def _grid_segments(hw: int = 32, n: int = 4):
    import numpy as np
    side = hw // n
    return (np.arange(hw)[:, None] // side * n
            + np.arange(hw)[None, :] // side).astype(np.int32)


def _linkage_heights(sim):
    import numpy as np
    from scipy.cluster import hierarchy
    from scipy.spatial.distance import squareform
    dist = 1.0 - np.nan_to_num(sim)
    np.fill_diagonal(dist, 0.0)
    return hierarchy.linkage(squareform(dist, checks=False),
                             method="complete")[:, 2]


def _replay_prob(bundle, start, finish, seg, chosen, target) -> float:
    """The target's float32 softmax on ``bundle`` once every segment in
    ``chosen`` has been taken from ``finish`` into ``start``."""
    import numpy as np
    import torch

    img = np.asarray(start).copy()
    for s in chosen:
        img = np.where((seg == s)[..., None], finish, img)
    x = torch.as_tensor(img.transpose(2, 0, 1)[None].copy(),
                        device=bundle.device)
    return float(bundle.probs(x)[0, target])


def first_flipped_pick(bundle, got, want, start, finish, seg, target,
                       skip=(), cutoff_prob=None):
    """The first round whose picks differ, or None; fails unless the two
    picks' float32 responses (``bundle``'s, at the running image both runs
    share up to that round, after ``skip``) are within MDA_PICK_TIE.  With
    ``cutoff_prob`` (the insertion search's cutoff as a probability), one
    run may stop a round before the other if its last response is within
    MDA_PICK_TIE of the cutoff."""
    got, want = [int(v) for v in got], [int(v) for v in want]
    if got == want:
        return None
    short = min(len(got), len(want))
    r = next((i for i, (a, b) in enumerate(zip(got, want)) if a != b),
             short)
    chosen = list(skip) + got[:r]
    if r == short:
        last = _replay_prob(bundle, start, finish, seg, chosen, target)
        if cutoff_prob is None or abs(last - cutoff_prob) > MDA_PICK_TIE:
            fail(f"MDA picks differ in length only: {got} vs {want} "
                 f"(response {last} at the shorter run's end, cutoff "
                 f"{cutoff_prob})")
        return r - 1
    resp = [_replay_prob(bundle, start, finish, seg, chosen + [c], target)
            for c in (got[r], want[r])]
    if abs(resp[0] - resp[1]) > MDA_PICK_TIE:
        fail(f"MDA pick {r} flipped card vs CPU, {got[r]} against "
             f"{want[r]}, responses {resp}: not a rounding-level tie")
    return r


@contextlib.contextmanager
def spied_mda_searches():
    """Records each greedy search of ``methods/mda.py`` while the block
    runs: its start and finish images, segments, picks, seeded skips and
    the insertion search's normalization and cutoff.  Yields the list."""
    import numpy as np

    from xai_tpu_torch.methods import mda as M

    searches = []
    real = M._greedy_search

    def spy(bundle, start, finish, seg_map, *a, **k):
        out = real(bundle, start, finish, seg_map, *a, **k)
        searches.append(dict(
            start=start.float().cpu().numpy(),
            finish=finish.float().cpu().numpy(),
            seg=np.asarray(seg_map), picks=list(out[0]),
            skip=[int(v) for v in k.get("skip") or []],
            norm=k.get("norm_pair"), cutoff=k.get("cutoff")))
        return out

    M._greedy_search = spy
    try:
        yield searches
    finally:
        M._greedy_search = real


def first_flipped_search(cpu_bundle, card, cpu, target, label):
    """The first of one MDA call's searches (insertion, then deletion)
    whose picks differ card vs CPU, as "<kind> round <r>", or None; each
    held by the first-flip rule (first_flipped_pick), the insertion search
    allowed to stop a round apart at a cutoff tie."""
    if len(card) != len(cpu):
        fail(f"{label}: {len(card)} vs {len(cpu)} searches card vs CPU")
    for kind, a, c in zip(("insertion", "deletion"), card, cpu):
        if a["skip"] != c["skip"]:
            fail(f"{label}: the {kind} search was seeded with {a['skip']} "
                 f"vs {c['skip']}")
        cut = None
        if c["norm"] is not None and c["cutoff"] is not None:
            orig, base = c["norm"]
            cut = base + c["cutoff"] * abs(orig - base)
        r = first_flipped_pick(cpu_bundle, a["picks"], c["picks"],
                               c["start"], c["finish"], c["seg"], target,
                               skip=c["skip"], cutoff_prob=cut)
        if r is not None:
            return f"{kind} round {r}"
    return None


def check_mda_entry(torch, bundles, imgs, trans, targets, rel) -> list:
    """get_attribution("vit", "MDA") card vs CPU on each image: the
    adaptive blur (the test ViT's flat softmax grows klen past 63, to the
    blur's two-launch width), bidirectional's prior, SLIC segments and the
    3x abs.  The klens must agree; each greedy search's picks, insertion
    then deletion, are held by the first-flip rule (the insertion search
    may also stop a round apart at a cutoff tie), and the maps within
    1e-4 where every pick agrees."""
    from xai_tpu_torch import registry as R

    runs = {}
    for name, b in bundles.items():
        runs[name] = []
        for x, t in zip(imgs, targets):
            klens = []
            adaptive = _spy(R, "adaptive_blur", klens, lambda out: out[1])
            try:
                with spied_mda_searches() as searches:
                    m = R.get_attribution("vit", "MDA", R.AttrContext(
                        bundle=b, x=torch.as_tensor(x, device=b.device),
                        trans_img=trans, target=t, img_hw=32))
            finally:
                R.adaptive_blur = adaptive
            runs[name].append((m, searches, klens))
    out = []
    for i, t in enumerate(targets):
        (mg, sg, kg), (mc, sc, kc) = runs["cuda"][i], runs["cpu"][i]
        label = f"tiny ViT registry MDA image {i}"
        if kg != kc:
            fail(f"{label}: klens {kg} vs {kc} card vs CPU")
        flip = first_flipped_search(bundles["cpu"], sg, sc, t, label)
        if flip is None:
            err = rel(mg, mc)
            if not err < 1e-4:
                fail(f"{label} card vs CPU: {err}")
            out.append(f"klen {kc[0]}: {err:.3g}")
        else:
            out.append(f"klen {kc[0]}: flip at {flip}")
    return out


def check_slice2_reference(torch, dev, have):
    """Phase 5, TIS, ViT-CX, MDA, refine_attribution, the classic metrics
    and PIC on xai_tpu's 32 px test ViT, card vs CPU in float32, to the
    CPU tests' tolerances: TIS with shared centroids (1e-4); ViT-CX with
    shared noise (labels equal, or a merge within 1e-5 of the 0.1
    threshold; maps 1e-4); MDA with grid segments (insertion picks equal
    up to a first flipped pick that is a rounding-level tie; maps 1e-4
    where the picks agree); refine_attribution, 3 epochs (1e-4); MAS, RISE,
    AIC, MoRF and Monotonicity curves (1e-5); PIC's SIC and AIC areas
    (1e-5, where PIL's WebP encoder imports)."""
    import numpy as np

    from xai_tpu_torch.methods import mas_calibrate as MC
    from xai_tpu_torch.methods import mda as M
    from xai_tpu_torch.methods import tis as T
    from xai_tpu_torch.methods import vit_cx as X
    from xai_tpu_torch.metrics import classic as K
    from xai_tpu_torch.ops.blur import make_blur_fn

    cpu = torch.device("cpu")
    rs = np.random.RandomState(2)
    imgs = rs.randn(3, 32, 32, 3).astype(np.float32)
    trans = np.random.RandomState(3).rand(32, 32, 3).astype(np.float32)
    base = np.abs(rs.randn(32, 32, 3)).astype(np.float32)
    sal = rs.rand(32, 32).astype(np.float32)
    cent = np.random.RandomState(4).rand(64, 16).astype(np.float32)
    targets = [3, 0, 11]
    seg = _grid_segments()
    prior = np.abs(np.random.RandomState(5).randn(32, 32, 3)).astype(
        np.float32)
    bundles = {"cuda": tiny_vit(torch, dev), "cpu": tiny_vit(torch, cpu)}
    out = {}
    for name, b in bundles.items():
        xs = torch.as_tensor(imgs, device=b.device)
        r = {}
        r["tis"] = np.stack([T.tis(b, x, t, n_masks=64, centroids=cent)
                             .cpu().numpy() for x, t in zip(xs, targets)])
        _, sims, _ = X._masks_and_sim(b, xs.permute(0, 3, 1, 2).contiguous())
        r["sims"] = sims.cpu().numpy()
        r["labels"] = [X.cluster_host(m, 0.1) for m in r["sims"]]
        r["ins"] = [M.find_insertion_patches(
            b, x, prior, seg, make_blur_fn(31, 31.0), 16, t)
            for x, t in zip(xs, targets)]
        r["mda"] = np.stack([M.mda(b, trans, x, prior, 16,
                                   make_blur_fn(31, 31.0), t, segments=seg)
                             for x, t in zip(xs, targets)])
        r["refine"] = MC.refine_attribution(b, xs[0], base, epochs=3)
        for cls, mode in (("MASMetric", "ins"), ("MASMetric", "del"),
                          ("RISEMetric", "ins"), ("AICMetric", "del"),
                          ("PositiveNegativePerturbation", "morf"),
                          ("MonotonicityMetric", "positive")):
            m = getattr(K, cls)(b, 32 * 32, mode, 32, make_blur_fn(31, 31.0))
            r[cls, mode] = m.single_run(xs[0], sal)
        out[name] = r
    gpu, ref = out["cuda"], out["cpu"]

    def rel(a, b):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        return float(np.abs(a - b).max() / (np.abs(b).max() or 1.0))

    report = {"TIS": rel(gpu["tis"], ref["tis"])}
    if not report["TIS"] < 1e-4:
        fail(f"tiny ViT TIS card vs CPU: {report['TIS']}")
    cx = []
    for i, (lg, lc) in enumerate(zip(gpu["labels"], ref["labels"])):
        if not np.array_equal(lg, lc):
            near = float(np.abs(_linkage_heights(ref["sims"][i]) - 0.1)
                         .min())
            if near > 1e-5:
                fail(f"tiny ViT ViT-CX image {i}: labels differ card vs CPU "
                     f"with no merge near the threshold ({near})")
            cx.append(f"image {i} labels flip at a merge {near:.2g} from "
                      f"the threshold")
            continue
        noise = (np.random.RandomState(i).randn(int(lc.max()) + 1, 32, 32, 3)
                 * 0.1).astype(np.float32)
        maps = [X.vit_cx(b, torch.as_tensor(imgs[i], device=b.device),
                         targets[i], noise=noise)
                for b in (bundles["cuda"], bundles["cpu"])]
        err = rel(*maps)
        if not err < 1e-4:
            fail(f"tiny ViT ViT-CX image {i} card vs CPU: {err}")
        cx.append(f"{err:.3g}")
    report["VIT_CX"] = cx
    flips = []
    for i in range(3):
        blurred = make_blur_fn(31, 31.0)(torch.as_tensor(
            imgs[i]).permute(2, 0, 1)[None])[0].permute(1, 2, 0).numpy()
        r = first_flipped_pick(bundles["cpu"], gpu["ins"][i][0],
                               ref["ins"][i][0], blurred, imgs[i], seg,
                               targets[i])
        flips.append(r)
        if r is None:
            err = rel(gpu["mda"][i], ref["mda"][i])
            if not err < 1e-4:
                fail(f"tiny ViT MDA image {i} card vs CPU: {err}")
    report["MDA"] = [f"{rel(g, c):.3g}" if f is None else f"flip at {f}"
                     for g, c, f in zip(gpu["mda"], ref["mda"], flips)]
    report["MDA entry"] = check_mda_entry(torch, bundles, imgs, trans,
                                          targets, rel)
    report["refine"] = rel(gpu["refine"], ref["refine"])
    if not report["refine"] < 1e-4:
        fail(f"tiny ViT refine_attribution card vs CPU: {report['refine']}")
    worst = 0.0
    for key in ref:
        if isinstance(key, tuple):
            for g, c in zip(gpu[key], ref[key]):
                d = float(np.abs(np.asarray(g, np.float64)
                                 - np.asarray(c, np.float64)).max())
                worst = max(worst, d)
    report["classic"] = worst
    if not worst < 1e-5:
        fail(f"tiny ViT classic metrics card vs CPU: {worst}")
    if have["webp"]:
        from xai_tpu_torch.metrics import pic as P
        img01 = np.random.RandomState(6).rand(32, 32, 3).astype(np.float32)
        mask = P.generate_random_mask(32, 32, 0.05,
                                      rng=np.random.RandomState(7))
        aucs = [[r.auc for r in P.compute_both_metrics(
            b, img01, sal, mask, normalize_fn=lambda v: (v - 0.5) / 0.5)]
            for b in (bundles["cuda"], bundles["cpu"])]
        report["PIC"] = max(abs(a - c) for a, c in zip(*aucs))
        if not report["PIC"] < 1e-5:
            fail(f"tiny ViT PIC card vs CPU: {aucs}")
    else:
        report["PIC"] = "skipped (no PIL WebP encoder)"
    print("tiny ViT 32 px slice 2, card vs CPU (max |delta| / CPU max): "
          f"TIS {report['TIS']:.3g} (< 1e-4); ViT-CX {report['VIT_CX']} "
          f"(< 1e-4); MDA maps {report['MDA']} (< 1e-4), insertion picks "
          f"{[p[0].tolist() for p in gpu['ins']]}; registry MDA "
          f"{report['MDA entry']} (< 1e-4); refine_attribution "
          f"{report['refine']:.3g} (< 1e-4); classic metrics max |delta| "
          f"{report['classic']:.3g} (< 1e-5); PIC areas {report['PIC']}")


def vit_forward_flops(cfg, tokens: int) -> float:
    """2 x the multiply-adds of one ViT forward that keeps ``tokens``
    tokens, by the config's shapes: the patch embedding (of every patch:
    TIS drops tokens after it), a block's qkv and projection (8 N D^2),
    MLP (4 r N D^2) and two attention products (4 N^2 D), the head."""
    d, n = cfg.embed_dim, tokens
    block = (8 + 4 * cfg.mlp_ratio) * n * d * d + 4 * n * n * d
    return (2 * (cfg.tokens - 1) * 3 * cfg.patch ** 2 * d
            + cfg.depth * block + 2 * d * cfg.num_classes)


def time_warm_slice2(torch, dev, card):
    """Phase 6, the slice-2 names on VIT16, warm (the driver paths ran
    them before), with CUDA events and peak memory: each name image by
    image through the registry in float32, TIS and VIT_CX in bf16, VIT_CX
    at B=4 in float32 and bf16 (batch_attribution); each call's forward
    rows and their FLOP by the model's shapes; MDA's klen printed."""
    import numpy as np

    from xai_tpu_torch import registry
    from xai_tpu_torch.methods.batch import batch_attribution
    from xai_tpu_torch.models import vit as tvit
    from xai_tpu_torch.registry import AttrContext, get_attribution
    from xai_tpu_torch.runners.common import (build_bundle, normalize_input,
                                              predict_classes)

    bundle = build_bundle("VIT16", device=dev)
    imgs = np.random.RandomState(0).rand(4, 224, 224, 3).astype(np.float32)
    xs = torch.stack([normalize_input(im, "vit", dev) for im in imgs])
    targets = predict_classes(bundle, xs)
    gens = [torch.Generator(dev).manual_seed(i) for i in range(4)]
    calls = []
    for name in SLICE2_NAMES:
        for dname, dtype in (("f32", None), ("bf16", torch.bfloat16)):
            if dtype is not None and name.startswith("MDA"):
                continue
            ctx = AttrContext(bundle=bundle, x=xs[0], trans_img=imgs[0],
                              target=targets[0], generator=gens[0],
                              dtype=dtype)
            calls.append((name, f"image {dname}", lambda ctx=ctx, n=name:
                          get_attribution("vit", n, ctx)[None], 1))
    for dname, dtype in (("f32", None), ("bf16", torch.bfloat16)):
        calls.append(("VIT_CX", f"b4 {dname}", lambda dtype=dtype: (
            batch_attribution("vit", "VIT_CX", bundle, xs, imgs, targets,
                              gens, dtype=dtype)), 4))
    klens = []
    adaptive = _spy(registry, "adaptive_blur", klens, lambda out: out[1])
    # every forward's rows and tokens, for the work each name does
    forwards = []
    forward = tvit.VisionTransformer.forward

    def counted(self, x, *a, token_indices=None, **k):
        n = self.cfg.tokens if token_indices is None \
            else token_indices.shape[-1] + 1
        forwards.append((x.shape[0], n))
        return forward(self, x, *a, token_indices=token_indices, **k)

    tvit.VisionTransformer.forward = counted
    rows = []
    try:
        for name, kind, fn, b in calls:
            forwards.clear()
            torch.cuda.reset_peak_memory_stats(dev)
            sal, sec = _event_s(torch, fn)
            if not (np.isfinite(sal).all() and sal.shape[0] == b):
                fail(f"warm VIT16 {name} {kind}: bad saliency")
            flop = sum(r * vit_forward_flops(bundle.extras, n)
                       for r, n in forwards)
            rows.append((name, kind, sec / b,
                         torch.cuda.max_memory_allocated(dev),
                         sum(r for r, _ in forwards) / b, flop / b))
    finally:
        registry.adaptive_blur = adaptive
        tvit.VisionTransformer.forward = forward
    for name, kind, sec, peak, rows_b, flop in rows:
        print(f"VIT16 warm {name} {kind}: {sec:.4f} s/image (peak memory "
              f"{peak / 2 ** 30:.2f} GiB); {rows_b:.0f} forward rows an "
              f"image, {flop / 1e12:.2f} TFLOP an image by the model's "
              f"shapes, {flop / sec / 1e12:.1f} TFLOP/s")
    print("VIT16 warm slice 2, s/image (CUDA events): " + ", ".join(
        f"{n} {k} {s:.4f}" for n, k, s, *_ in rows)
        + f"; MDA's adaptive blur stopped at klen {klens} on {card}")


@contextlib.contextmanager
def tiny_vit_model(img_hw: int):
    """--model TINY_VIT as the test ViT at ``img_hw`` (the constructor's
    config replaced for the duration, as the CPU tests do)."""
    from xai_tpu_torch.models import vit as tvit

    key = "vit_tiny_patch16_224"
    old = tvit.CONFIGS[key]
    tvit.CONFIGS[key] = tvit.ViTConfig(**dict(VIT32PX, img_hw=img_hw))
    try:
        yield
    finally:
        tvit.CONFIGS[key] = old


def check_tiny_vit_drivers(torch, dev):
    """Phase 5, the ViT drivers: --model TINY_VIT as the test ViT at 48 px
    (so that HOG has a block) on the card against the CPU: the randomized
    weights bit-equal, the sanity CSV and the seg TXT of rollout and
    t_attr (t_attr also at --image_batch 2) within 2e-3."""
    from xai_tpu_torch.runners import evaluate_imagenet_seg as eg
    from xai_tpu_torch.runners import evaluate_sanity as es
    from xai_tpu_torch.runners.common import build_bundle

    cpu = torch.device("cpu")
    report = []
    with tiny_vit_model(48), tempfile.TemporaryDirectory() as out_dir:
        weights = [{k: v.cpu() for k, v in es.randomize_family(
            build_bundle("TINY_VIT", device=d), "vit",
            torch.Generator().manual_seed(1)).module.state_dict().items()}
            for d in (dev, cpu)]
        if not all(torch.equal(weights[0][k], weights[1][k])
                   for k in weights[1]):
            fail("the sanity driver's randomized ViT differs card vs CPU")
        for name, batch in (("rollout", 1), ("t_attr", 1), ("t_attr", 2)):
            for drv, fn, parser in (
                    ("sanity", es.evaluate_sanity, es.build_parser),
                    ("seg", eg.evaluate_imagenet_seg, eg.build_parser)):
                flags = ["--model", "TINY_VIT", "--attr_func", name,
                         "--synthetic", "3", "--image_batch", str(batch),
                         "--output_dir", out_dir]
                if drv == "sanity":
                    flags += ["--image_count", "3"]
                got, want = (fn(parser().parse_args(flags), device=d)
                             for d in (dev, cpu))
                same_nan = all(math.isnan(got[k]) == math.isnan(want[k])
                               for k in want)
                worst = max((abs(got[k] - want[k]) for k in want
                             if not math.isnan(want[k])), default=0.0)
                report.append(f"{drv} {name} B={batch} {worst:.3g}")
                if not (same_nan and worst < 2e-3):
                    fail(f"TINY_VIT {drv} {name} B={batch} on the card "
                         f"differs from the CPU: {got} vs {want}")
    print("TINY_VIT (test ViT at 48 px), the drivers card vs CPU: "
          "randomized weights bit-equal; max |score delta| (< 2e-3): "
          + ", ".join(report))


def time_warm_vit(torch, dev, card):
    """Phase 6, the ViT family on VIT16, warm, with CUDA events: each
    name's s/image image by image (the registry) and at B=4 in float32
    and bf16 (batch_attribution), with peak memory; the battery image by
    image; sanity-rollout and seg-rollout per image, split into
    attribution and host metrics; the image finder's images a second at
    --batch_size 100 (end to end and the forward alone).  Rollout in
    float32 and its battery at B=4 are the cell vit16_rollout_b4's."""
    import numpy as np

    from xai_tpu_torch.data.segmentation import ImagenetSegmentation
    from xai_tpu_torch.methods.batch import batch_attribution
    from xai_tpu_torch.metrics.curves import run_battery
    from xai_tpu_torch.metrics.sanity import evaluate as sanity_evaluate
    from xai_tpu_torch.metrics.seg import eval_batch
    from xai_tpu_torch.registry import AttrContext, get_attribution
    from xai_tpu_torch.runners import evaluate_sanity as es
    from xai_tpu_torch.runners import image_finder as fi
    from xai_tpu_torch.runners.common import (build_bundle, default_blur,
                                              normalize_input,
                                              predict_classes)

    bundle = build_bundle("VIT16", device=dev)
    imgs = np.random.RandomState(0).rand(4, 224, 224, 3).astype(np.float32)
    xs = torch.stack([normalize_input(im, "vit", dev) for im in imgs])
    targets = predict_classes(bundle, xs)
    out = {}
    for name in VIT_NAMES:
        ctx = AttrContext(bundle=bundle, x=xs[0], trans_img=imgs[0],
                          target=targets[0])
        calls = [("image", lambda: get_attribution("vit", name, ctx)[None],
                  1)]
        for dname, dtype in (("f32", None), ("bf16", torch.bfloat16)):
            if (name, dname) != ("rollout", "f32"):
                calls.append((f"b4 {dname}", lambda dtype=dtype: (
                    batch_attribution("vit", name, bundle, xs, imgs,
                                      targets, None, dtype=dtype)), 4))
        for kind, fn, b in calls:
            fn()                                     # warm
            torch.cuda.reset_peak_memory_stats(dev)
            sal, sec = _event_s(torch, fn)
            if not np.isfinite(sal).all():
                fail(f"warm VIT16 {name} {kind}: non-finite saliency")
            out[name, kind] = (sec / b, torch.cuda.max_memory_allocated(dev))
    for (name, kind), (sec, peak) in out.items():
        print(f"VIT16 warm {name} {kind}: {sec:.4f} s/image (peak memory "
              f"{peak / 2 ** 30:.2f} GiB)")
    print("VIT16 warm, s/image (CUDA events), image by image / B=4 f32 / "
          "B=4 bf16: " + ", ".join(
              f"{n} " + " / ".join(
                  f"{out[n, k][0]:.4f}" if (n, k) in out else "cell"
                  for k in ("image", "b4 f32", "b4 bf16"))
              for n in VIT_NAMES) + f" on {card}")

    sal1 = get_attribution("vit", "rollout", AttrContext(
        bundle=bundle, x=xs[0], trans_img=imgs[0], target=targets[0]))
    blur = default_blur()
    for _ in range(2):                       # the first round warms up
        torch.cuda.reset_peak_memory_stats(dev)
        _, t1 = _event_s(torch, lambda: run_battery(
            bundle.apply, xs[0], sal1, blur, chunk=45, target=targets[0]))
        peak1 = torch.cuda.max_memory_allocated(dev)
    print(f"VIT16 warm battery: {t1:.4f} s/image image by image (peak "
          f"{peak1 / 2 ** 30:.2f} GiB) on {card}")

    rand = es.randomize_family(bundle, "vit",
                               torch.Generator().manual_seed(1))
    item = next(iter(ImagenetSegmentation("", 224, synthetic=1)))
    x = normalize_input(item.trans_img, "vit", dev)

    def rollout(b):
        return get_attribution("vit", "rollout", AttrContext(
            bundle=b, x=x, trans_img=item.trans_img,
            target=predict_classes(b, x[None])[0]))

    for _ in range(2):                      # the first round warms up
        a, t_a = _event_s(torch, lambda: rollout(bundle))
        ar, t_r = _event_s(torch, lambda: rollout(rand))
        t0 = time.perf_counter()
        sanity_evaluate(a, ar)
        t_host = time.perf_counter() - t0
        t0 = time.perf_counter()
        eval_batch(a, item.gt_mask)
        t_seg = time.perf_counter() - t0
    print(f"VIT16 warm sanity-rollout: {t_a + t_r + t_host:.4f} s/image = "
          f"rollout trained {t_a:.4f} + randomized {t_r:.4f} (CUDA events) "
          f"+ host SSIM/Spearman/HOG {t_host:.4f}; seg-rollout: "
          f"{t_a + t_seg:.4f} s/image = rollout {t_a:.4f} + host metrics "
          f"{t_seg:.4f} on {card}")

    n = 500
    with tempfile.TemporaryDirectory() as d:
        gt = os.path.join(d, "gt.txt")
        with open(gt, "w") as f:
            f.write("1\n" * n)
        args = fi.build_parser().parse_args(
            ["--model", "VIT16", "--synthetic", str(n), "--batch_size",
             "100", "--ground_truth", gt, "--class_maps_dir", d])
        for _ in range(2):                  # the first round warms up
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()):
                fi.find_correctly_classified(args, device=dev)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    build_bundle("VIT16", device=dev)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    xb = torch.as_tensor(np.random.RandomState(1).rand(100, 224, 224, 3),
                         dtype=torch.float32, device=dev)
    for _ in range(2):
        torch.cuda.reset_peak_memory_stats(dev)
        _, t_fwd = _event_s(torch, lambda: predict_classes(bundle, xb))
    peak = torch.cuda.max_memory_allocated(dev)
    print(f"VIT16 warm image_finder at --batch_size 100: "
          f"{n / (wall - t_build):.1f} images/s end to end ({n} synthetic "
          f"images in {wall:.3f} s, of it {t_build:.3f} s building the "
          f"bundle); the batched forward alone {100 / t_fwd:.1f} images/s "
          f"({t_fwd * 1e3:.2f} ms a batch of 100, peak "
          f"{peak / 2 ** 30:.2f} GiB, CUDA events) on {card}")


# --- the CLIP family (ROADMAP A11) ---

CLIP_NAMES = ("eclip", "eclip_nograd", "eclip_wo", "maskclip", "grad_cam",
              "selfattn", "game", "rollout", "lrp", "m2ib", "surgery",
              "rise")
# the 11 that xai_tpu batches (CLIP_EXTRA_KIND): all but rise
CLIP_BATCHED = CLIP_NAMES[:-1]
CLIP_BF16 = ("eclip", "game", "m2ib")
# xai_tpu's test CLIP (tests/test_batch_attr.py clip_setup), and its widths
# with the real vocabulary and context for the drivers
CLIP32PX = dict(patch=8, vision_width=32, vision_layers=2, vision_heads=4,
                embed_dim=16, text_width=16, text_heads=2, text_layers=2,
                vocab_size=50, context_length=12, img_hw=32)
CLIP_TOKS = [[1, 5, 9, 49, 0, 0, 0, 0, 0, 0, 0, 0],
             [3, 7, 49, 0, 0, 0, 0, 0, 0, 0, 0, 0],
             [2, 4, 6, 8, 49, 0, 0, 0, 0, 0, 0, 0]]


def two_class_images(torch, dev, model: str, n: int = 128) -> tuple:
    """(k, classes of the first n images): the first k images of the
    --synthetic stream hold two of ``model``'s classes (seeded random
    weights, as the drivers build them), so that --synthetic k
    --image_count 2 scores two images of two classes.  Random CLIP
    weights give nearly every noise image one class (CLIP16: image 74 is
    the first of another)."""
    classes = model_classes(torch, dev, model, n)
    k = next((i + 1 for i, c in enumerate(classes) if c != classes[0]),
             None)
    if k is None:
        fail(f"{model} gives the {n} synthetic images one class: no two "
             f"images of two classes to score")
    print(f"{model}: synthetic image {k} is the first of a second class")
    return k, classes


def clip_paths(k16: int, k32: int) -> list:
    """Phase 4, the flagship driver on CLIP16 (and CLIP32): the 12 names
    image by image on two images of two classes (the first ``k16``, ``k32``
    synthetic images, two_class_images), the 11 batched names at
    --image_batch 4 in float32, eclip, game and m2ib in bf16; on CLIP32
    eclip image by image and lrp at B=4; (label, flags, images,
    --image_count, --image_batch, model, images to score)."""
    return ([(f"clip16_{n}", ["--attr_func", n], k16, 2, 1, "CLIP16", 2)
             for n in CLIP_NAMES]
            + [(f"clip16_{n}_b4", ["--attr_func", n], 4, 4000, 4, "CLIP16", 4)
               for n in CLIP_BATCHED]
            + [(f"clip16_{n}_b4_bf16", ["--attr_func", n, "--attr_dtype",
                                        "bf16"], 4, 4000, 4, "CLIP16", 4)
               for n in CLIP_BF16]
            + [("clip32_eclip", ["--attr_func", "eclip"], k32, 2, 1,
                "CLIP32", 2),
               ("clip32_lrp_b4", ["--attr_func", "lrp"], 4, 4000, 4,
                "CLIP32", 4)])


def drive_clip_driver_paths(torch, dev, out_dir, classes, have) -> dict:
    """Phase 4, the other drivers on CLIP16 at 224 px, each through its
    entry point with its launches: sanity (eclip image by image, rollout
    at B=4 in bf16; the randomized model's text table rebuilt; SPR and
    HOG NaN only where a map is constant), segmentation (eclip, maskclip
    at B=4), the image finder, the 9-name CLIP panel (no name fails; the
    PNG where matplotlib imports) and the sweep's CLIP16 rows (pert,
    sanity, seg x eclip, rollout); ``classes``: CLIP16's class of each
    synthetic image.  Returns the launches by path."""
    import numpy as np

    from xai_tpu_torch.runners import evaluate_imagenet_seg as eg
    from xai_tpu_torch.runners import evaluate_sanity as es
    from xai_tpu_torch.runners import image_finder as fi
    from xai_tpu_torch.runners import qualitative_generation as qg
    from xai_tpu_torch.runners import sweep as sw

    by_path = {}
    for label, flags, n in (
            ("clip16_sanity_eclip", ["--attr_func", "eclip", "--synthetic",
                                     "2", "--image_count", "2"], 2),
            ("clip16_sanity_rollout_b4_bf16",
             ["--attr_func", "rollout", "--image_batch", "4",
              "--synthetic", "4", "--image_count", "4", "--attr_dtype",
              "bf16"], 4)):
        d = os.path.join(out_dir, label)
        args = es.build_parser().parse_args(
            ["--model", "CLIP16", *flags, "--output_dir", d])
        maps = []        # per call: [B, H, W], trained then randomized
        get_attr = _spy(es, "get_attribution", maps, lambda m: m[None])
        batch_attr = _spy(es, "batch_attribute", maps, lambda out: out[0])
        try:
            _, by_path[label] = run_path(
                torch, label, lambda: es.evaluate_sanity(args, device=dev),
                NO_LAUNCHES)
        finally:
            es.get_attribution, es.batch_attribute = get_attr, batch_attr
        pairs = list(zip(np.concatenate(maps[0::2]),
                         np.concatenate(maps[1::2])))
        check_constant_maps(label, _read_sanity_csv(os.path.join(
            d, "CLIP16", f"{args.attr_func}_{args.image_count}_images.csv")),
            pairs, n)
    for label, flags in (
            ("clip16_seg_eclip", ["--attr_func", "eclip", "--synthetic",
                                  "2"]),
            ("clip16_seg_maskclip_b4", ["--attr_func", "maskclip",
                                        "--image_batch", "4", "--synthetic",
                                        "4"])):
        d = os.path.join(out_dir, label)
        args = eg.build_parser().parse_args(
            ["--model", "CLIP16", *flags, "--output_dir", d])
        _, by_path[label] = run_path(
            torch, label, lambda: eg.evaluate_imagenet_seg(args, device=dev),
            NO_LAUNCHES)
        _finite_scores(label, _read_seg_txt(os.path.join(
            d, "CLIP16", f"{args.attr_func}_0_images")), SEG_LINES)

    gt = os.path.join(out_dir, "clip16_ground_truth.txt")
    with open(gt, "w") as f:
        f.writelines(f"{c if i % 2 == 0 else (c + 1) % 1000}\n"
                     for i, c in enumerate(classes[:8]))
    args = fi.build_parser().parse_args(
        ["--model", "CLIP16", "--synthetic", "8", "--batch_size", "4",
         "--ground_truth", gt, "--class_maps_dir",
         os.path.join(out_dir, "class_maps")])
    mask, by_path["clip16_image_finder"] = run_path(
        torch, "clip16_image_finder",
        lambda: fi.find_correctly_classified(args, device=dev), NO_LAUNCHES)
    if mask.tolist() != [1, 0] * 4:
        fail(f"CLIP16 image_finder mask {mask.tolist()}")
    print(f"clip16_image_finder: mask {mask.tolist()} as constructed")

    panels = []
    panel_maps = _spy(qg, "panel_maps", panels)
    try:
        if have["matplotlib"]:
            args = qg.build_parser().parse_args(
                ["--model", "CLIP16", "--synthetic", "1", "--output_dir",
                 os.path.join(out_dir, "clip_qualitative")])
            written, by_path["clip16_qualitative"] = run_path(
                torch, "clip16_qualitative",
                lambda: qg.generate(args, device=dev), NO_LAUNCHES)
            if list(written.values()) != [[]]:
                fail(f"CLIP qualitative grid: {written}")
        else:
            from xai_tpu_torch.data.imagenet import ImageNetValStream
            from xai_tpu_torch.runners.common import build_bundle

            bundle = build_bundle("CLIP16", device=dev)
            item = next(iter(ImageNetValStream("", 224, synthetic=1)))
            _, by_path["clip16_qualitative"] = run_path(
                torch, "clip16_qualitative", lambda: qg.panel_maps(
                    bundle, item, qg.CLIP_PANEL, 0, dev), NO_LAUNCHES)
    finally:
        qg.panel_maps = panel_maps
    maps, failed = panels[0]
    if (failed or sorted(maps) != sorted(qg.CLIP_PANEL)
            or not all(np.isfinite(m).all() and m.shape == (224, 224)
                       for m in maps.values())):
        fail(f"CLIP qualitative panel: failed {failed}, maps {sorted(maps)}")
    print(f"clip16_qualitative: all {len(maps)} CLIP panel maps finite, "
          f"none failed")

    d = os.path.join(out_dir, "clip_sweep")
    args = sw.build_parser().parse_args(
        ["--drivers", "pert,sanity,seg", "--models", "CLIP16", "--methods",
         "eclip,rollout", "--synthetic", "2", "--image_count", "2",
         "--output_dir", d])
    scored = 2 * len(set(classes[:2]))
    sanity_maps = []
    get_attr = _spy(es, "get_attribution", sanity_maps)
    try:
        records, by_path["clip16_sweep"] = run_path(
            torch, "clip16_sweep", lambda: sw.run_sweep(args, device=dev),
            dict(NO_LAUNCHES, blur_planes=scored,
                 reveal_batch=REVEAL_PER_BATTERY * scored))
    finally:
        es.get_attribution = get_attr
    with open(os.path.join(d, "sweep_manifest.jsonl")) as f:
        manifest = [json.loads(line) for line in f]
    if len(manifest) != 6 or records != manifest or not all(
            r["status"] == "ok" for r in manifest):
        fail(f"CLIP sweep manifest: {manifest}")
    for r in manifest:
        if r["driver"] == "sanity":
            m, sanity_maps[:4] = sanity_maps[:4], []
            check_constant_maps(f"clip16_sweep sanity/{r['attr_func']}",
                                r["scores"], list(zip(m[0::2], m[1::2])), 2)
        else:
            _finite_scores(f"clip16_sweep {r['driver']}/{r['attr_func']}",
                           r["scores"], list(r["scores"]))
    print("clip16_sweep: 6 manifest rows, all ok: " + ", ".join(
        f"{r['driver']}/{r['attr_func']} {r['seconds']} s" for r in manifest))
    return by_path


def tiny_clip(torch, device, img_hw: int = 32):
    """xai_tpu's test CLIP (CLIP32PX) at ``img_hw``, flax-scheme random
    weights of seed 0 and the 10-row text table of a seeded draw, with the
    token rows CLIP_TOKS, on ``device``."""
    from xai_tpu_torch.models import clip as tclip
    from xai_tpu_torch.models.common import ModelMeta
    from xai_tpu_torch.ops.preprocess import CLIP_MEAN, CLIP_STD

    cfg = tclip.CLIPConfig(**dict(CLIP32PX, img_hw=img_hw))
    module = tclip.init_random(tclip.CLIP(cfg), seed=0).to(device)
    te = torch.randn(10, cfg.embed_dim,
                     generator=torch.Generator().manual_seed(3))
    te = (te / te.norm(dim=-1, keepdim=True)).to(device)
    meta = ModelMeta(name="smallclip", family="clip", img_hw=img_hw,
                     num_classes=10, num_patches=cfg.grid, batch_size=8,
                     mean=CLIP_MEAN, std=CLIP_STD)
    return tclip.CLIPBundle(meta, module, te)


def check_clip_reference(torch, dev):
    """Phase 5, the CLIP family: xai_tpu's tiny test CLIP at 32 px on the
    card against the same code on the CPU, in float32: the 10 names that
    draw nothing single (registry) and the 10 of them that batch at B=3
    (batch_attribution), m2ib at B=3 on shared noise, rise on shared
    masks, each within 1e-4 of the CPU's largest value; then the
    randomized tiny CLIP (its driver-sized widths, the real prompt table,
    48 px so that HOG has a block) through the sanity driver, the
    randomized weights bit-equal, the sanity CSV (eclip, rollout; rollout
    also at --image_batch 2) within 2e-3 of the CPU's."""
    import numpy as np

    from xai_tpu_torch.methods import clip_m2ib as TI
    from xai_tpu_torch.methods.batch import batch_attribution
    from xai_tpu_torch.methods.rise import rise
    from xai_tpu_torch.models import clip as tclip
    from xai_tpu_torch.registry import AttrContext, get_attribution

    cpu = torch.device("cpu")
    imgs = np.random.RandomState(4).randn(3, 32, 32, 3).astype(np.float32)
    targets = [0, 5, 9]
    draw_free = [n for n in CLIP_BATCHED if n != "m2ib"]
    cfg = tclip.CLIPConfig(**CLIP32PX)
    noises = torch.randn((3, 10, 10, cfg.tokens, cfg.vision_width),
                         generator=torch.Generator().manual_seed(5))
    masks = torch.rand((40, 32, 32),
                       generator=torch.Generator().manual_seed(6))
    runs = {}
    for name, d in (("cuda", dev), ("cpu", cpu)):
        bundle = tiny_clip(torch, d)
        xs = torch.as_tensor(imgs, device=d)
        ex = {"txt_emb": bundle.text_embeddings[targets],
              "text_tokens": torch.tensor(CLIP_TOKS, device=d)}
        out = {}
        for m in draw_free:
            out[m, "single"] = np.stack([get_attribution(
                "clip", m, AttrContext(
                    bundle=bundle, x=x, trans_img=im, target=t, img_hw=32,
                    extras={k: v[i:i + 1] for k, v in ex.items()}))
                for i, (x, im, t) in enumerate(zip(xs, imgs, targets))])
            out[m, "b3"] = batch_attribution("clip", m, bundle, imgs, imgs,
                                             targets, None, img_hw=32,
                                             extras=ex)
        out["m2ib", "b3"] = TI.vision_heatmap_iba(
            bundle, xs, ex["txt_emb"], noises=noises).cpu().numpy()
        out["rise", "single"] = rise(bundle, xs[0], 5,
                                     masks=masks.to(d)).cpu().numpy()
        runs[name] = out
    worst = {}
    for key, want in runs["cpu"].items():
        got = runs["cuda"][key]
        err = float(np.abs(got - want).max()) / (float(np.abs(want).max())
                                                 or 1.0)
        worst[key] = err
        if not (np.isfinite(got).all() and err < 1e-4):
            fail(f"tiny CLIP {key} on the card differs from the CPU: {err}")
    print("tiny CLIP 32 px, card vs CPU, max |delta| / CPU max (< 1e-4): "
          + ", ".join(f"{m} {worst[m, 'single']:.3g} / B=3 "
                      f"{worst[m, 'b3']:.3g}" for m in draw_free)
          + f", m2ib B=3 {worst['m2ib', 'b3']:.3g}, rise "
          f"{worst['rise', 'single']:.3g}")
    check_tiny_clip_sanity(torch, dev)


@contextlib.contextmanager
def tiny_clip_model(img_hw: int):
    """--model CLIP16 as the test CLIP's widths with the real vocabulary
    and context at ``img_hw`` (the constructor's config replaced for the
    duration, as the CPU tests do)."""
    from xai_tpu_torch.models import clip as tclip

    key = "clip_vit_b16"
    old = tclip.CONFIGS[key]
    tclip.CONFIGS[key] = tclip.CLIPConfig(**dict(
        CLIP32PX, vocab_size=49408, context_length=77, img_hw=img_hw))
    try:
        yield
    finally:
        tclip.CONFIGS[key] = old


def check_tiny_clip_sanity(torch, dev):
    """Phase 5, the CLIP sanity driver card vs CPU: --model CLIP16 as the
    test CLIP's widths at 48 px, its randomized weights bit-equal and its
    rebuilt text table within 1e-5, the CSV of eclip and rollout (rollout
    also at --image_batch 2) within 2e-3."""
    from xai_tpu_torch.runners import evaluate_sanity as es
    from xai_tpu_torch.runners.common import build_bundle

    cpu = torch.device("cpu")
    report = []
    with tiny_clip_model(48), tempfile.TemporaryDirectory() as out_dir:
        rand = [es.randomize_family(build_bundle("CLIP16", device=d), "clip",
                                    torch.Generator().manual_seed(1))
                for d in (dev, cpu)]
        weights = [{k: v.cpu() for k, v in r.module.state_dict().items()}
                   for r in rand]
        if not all(torch.equal(weights[0][k], weights[1][k])
                   for k in weights[1]):
            fail("the sanity driver's randomized CLIP differs card vs CPU")
        te = float((rand[0].text_embeddings.cpu()
                    - rand[1].text_embeddings).abs().max())
        if not te < 1e-5:
            fail(f"the randomized CLIP's text table differs card vs CPU: "
                 f"{te}")
        for name, batch in (("eclip", 1), ("rollout", 1), ("rollout", 2)):
            flags = ["--model", "CLIP16", "--attr_func", name, "--synthetic",
                     "3", "--image_count", "3", "--image_batch", str(batch),
                     "--output_dir", out_dir]
            got, want = (es.evaluate_sanity(es.build_parser().parse_args(
                flags), device=d) for d in (dev, cpu))
            same_nan = all(math.isnan(got[k]) == math.isnan(want[k])
                           for k in want)
            worst = max((abs(got[k] - want[k]) for k in want
                         if not math.isnan(want[k])), default=0.0)
            report.append(f"{name} B={batch} {worst:.3g} "
                          f"({json.dumps(want)})")
            if not (same_nan and worst < 2e-3):
                fail(f"tiny CLIP sanity {name} B={batch} on the card "
                     f"differs from the CPU: {got} vs {want}")
    print("tiny CLIP (48 px, real prompt table), randomized: weights "
          f"bit-equal card vs CPU, text table within {te:.3g}; sanity CSV "
          "max |score delta| (< 2e-3): " + ", ".join(report))


def time_warm_clip(torch, dev, card):
    """Phase 6, the CLIP family on CLIP16, warm, with CUDA events: the
    text table's build; each name's s/image image by image (the registry)
    and, for the 11 batched, at B=4 in float32 and bf16
    (batch_attribution), with peak memory and bf16's Spearman rho against
    float32 per image (> 0.95); the battery image by image and at B=4;
    CLIP32's battery image by image."""
    import numpy as np

    from xai_tpu_torch.methods.batch import batch_attribution
    from xai_tpu_torch.metrics.curves import run_battery
    from xai_tpu_torch.models import clip as tclip
    from xai_tpu_torch.ops.stats import spearman_np
    from xai_tpu_torch.parallel.sharded_battery import sharded_battery_scores
    from xai_tpu_torch.registry import get_attribution
    from xai_tpu_torch.runners.common import (attr_context, build_bundle,
                                              default_blur, image_generator,
                                              normalize_input,
                                              predict_classes)

    bundle = build_bundle("CLIP16", device=dev)
    for _ in range(2):                      # the first round warms up
        t0 = time.perf_counter()
        tokens = tclip.class_prompt_tokens()
        t_tok = time.perf_counter() - t0
        _, t_table = _event_s(torch, lambda: tclip.attach_text_table(
            bundle, tokens))
    print(f"CLIP16 warm text table: {t_table:.4f} s on the card (1000 "
          f"prompts x 77 tokens, 8 chunks of 125, CUDA events) + "
          f"{t_tok:.4f} s tokenizing on the host (cached BPE) on {card}")

    imgs = np.random.RandomState(0).rand(4, 224, 224, 3).astype(np.float32)
    xs = torch.stack([normalize_input(im, "clip", dev) for im in imgs])
    targets = predict_classes(bundle, xs)
    ex = tclip.batch_extras(bundle, targets)
    out, rho = {}, {}
    for name in CLIP_NAMES:
        p = {"x": xs[0], "trans_img": imgs[0], "target": targets[0],
             "generator": image_generator(0, 0, dev)}
        calls = [("image", lambda: get_attribution(
            "clip", name, attr_context(bundle, p))[None], 1)]
        if name in CLIP_BATCHED:
            for dname, dtype in (("f32", None), ("bf16", torch.bfloat16)):
                calls.append((f"b4 {dname}", lambda dtype=dtype: (
                    batch_attribution(
                        "clip", name, bundle, xs, imgs, targets,
                        [image_generator(0, i, dev) for i in range(4)],
                        dtype=dtype, extras=ex)), 4))
        maps = {}
        for kind, fn, b in calls:
            fn()                                     # warm
            torch.cuda.reset_peak_memory_stats(dev)
            maps[kind], sec = _event_s(torch, fn)
            if not np.isfinite(maps[kind]).all():
                fail(f"warm CLIP16 {name} {kind}: non-finite saliency")
            out[name, kind] = (sec / b,
                               torch.cuda.max_memory_allocated(dev))
        if name in CLIP_BATCHED:
            rho[name] = [spearman_np(a, b) for a, b in
                         zip(maps["b4 f32"], maps["b4 bf16"])]
    for (name, kind), (sec, peak) in out.items():
        print(f"CLIP16 warm {name} {kind}: {sec:.4f} s/image (peak memory "
              f"{peak / 2 ** 30:.2f} GiB)")
    print("CLIP16 warm, s/image (CUDA events), image by image / B=4 f32 / "
          "B=4 bf16: " + ", ".join(
              f"{n} {out[n, 'image'][0]:.4f}" + (
                  f" / {out[n, 'b4 f32'][0]:.4f} / {out[n, 'b4 bf16'][0]:.4f}"
                  if n in CLIP_BATCHED else "") for n in CLIP_NAMES)
          + f" on {card}")
    print("CLIP16 bf16 against float32 at B=4, Spearman rho per image: "
          + ", ".join(f"{n} {min(r):.4f}" for n, r in rho.items()))
    low = {n: r for n, r in rho.items() if not min(r) > 0.95}
    if low:
        fail(f"CLIP16 bf16 maps rank unlike float32 (rho <= 0.95): {low}")

    sal1 = get_attribution("clip", "eclip", attr_context(bundle, {
        "x": xs[0], "trans_img": imgs[0], "target": targets[0],
        "generator": None}))
    sals = batch_attribution("clip", "eclip", bundle, xs, imgs, targets,
                             None, extras=ex)
    blur = default_blur()
    for _ in range(2):                       # the first round warms up
        torch.cuda.reset_peak_memory_stats(dev)
        _, t1 = _event_s(torch, lambda: run_battery(
            bundle.apply, xs[0], sal1, blur, chunk=45, target=targets[0]))
        peak1 = torch.cuda.max_memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        _, t4 = _event_s(torch, lambda: sharded_battery_scores(
            bundle, xs, sals, blur, 45, targets))
        peak4 = torch.cuda.max_memory_allocated(dev)
    b32 = build_bundle("CLIP32", device=dev)
    x32 = normalize_input(imgs[0], "clip", dev)
    t32 = predict_classes(b32, x32[None])[0]
    for _ in range(2):
        _, t1_32 = _event_s(torch, lambda: run_battery(
            b32.apply, x32, sal1, blur, chunk=45, target=t32))
    print(f"CLIP16 warm battery: {t1:.4f} s/image image by image (peak "
          f"{peak1 / 2 ** 30:.2f} GiB), {t4 / 4:.4f} s/image at B=4 (peak "
          f"{peak4 / 2 ** 30:.2f} GiB); CLIP32 {t1_32:.4f} s/image image by "
          f"image; 675 forwards each on {card}")


# --- the extended model zoo (ROADMAP A13) ---

# the 15 names of xai_tpu's EXTENDED_ZOO outside the drivers' table
ZOO_NAMES = ("VGG16", "VGG19", "IV3", "CONVNXT", "swin_tiny", "swin_small",
             "swin_base", "pvt_tiny", "pvt_small", "pvt_med", "MAXVIT",
             "VIT8", "VIT_tiny", "VIT_base", "VIT_large")
ZOO_IMAGES = 200           # the finder's stream: two batches of 100
ZOO_FULL_TOL = 1e-3        # full width, card vs CPU, of max |logit|
ZOO_SMALL_TOL = 1e-4       # small widths, card vs CPU, relative


def zoo_small_models():
    """Each family at small widths (CPU modules), with the input size that
    makes it do what XLA does at 224 px and more: SAME padding that pads
    (ConvNeXt's 2x2 downsampling of a 9 px grid, PVT's sr conv of 3 on an
    8 px grid), shifted Swin windows beside a window that covers its grid,
    PVT's spatial reduction in the cls stage; Inception-v3 at its full
    widths and its smallest input.  name -> (module, px)."""
    from xai_tpu_torch.models import (convnext, inception, maxvit, pvt,
                                      swin, vgg)
    vgg11 = (8, "M", 16, "M", 32, 32, "M", 64, 64, "M", 64, 64, "M")
    return {
        "vgg11_small": (vgg.VGG(vgg11, 10, 32, img_hw=32), 32),
        "inception_v3": (inception.InceptionV3(), 75),
        "convnext_small_widths": (convnext.ConvNeXt((1, 2), (8, 16), 10),
                                  36),
        "swin_small_widths": (swin.SwinTransformer(
            (2, 2, 2), (2, 2, 4), 8, 4, 10, img_hw=64), 64),
        "pvt_small_widths": (pvt.PVT(
            (1, 1, 2), (8, 16, 24), (1, 2, 2), (2, 2, 2), (3, 2, 2),
            (4, 2, 2), 10, img_hw=32), 32),
        "maxvit_tv_small_widths": (maxvit.MaxViTTV(
            (1, 1), (16, 32), 16, 4, 8, 10, img_hw=64), 64),
        "maxvit_paper_small_widths": (maxvit.MaxViT(
            (2, 1), (16, 32), 16, 4, 10, img_hw=64), 64),
    }


def check_zoo_reference(torch, dev):
    """Phase 5, the zoo's families at small widths on the card against the
    same modules on the CPU, in float32 with TF32 off: logits and every
    tap within 1e-4 of the CPU's largest value.  The weights are flax's
    scheme with every LayerNorm, folded-BN and layer-scale entry and
    every bias and table redrawn, so that each array counts."""
    import copy

    import numpy as np

    from xai_tpu_torch.models.common import init_flax_default

    for label, (module, hw) in zoo_small_models().items():
        gen = torch.Generator().manual_seed(7)
        init_flax_default(module, seed=3)
        with torch.no_grad():
            for name, p in module.named_parameters():
                leaf = name.rsplit(".", 1)[-1]
                if leaf == "scale":
                    p.copy_(1 + 0.2 * torch.randn(p.shape, generator=gen))
                elif leaf == "gamma":
                    p.copy_(0.5 + torch.rand(p.shape, generator=gen))
                elif leaf != "weight":
                    p.copy_(0.05 * torch.randn(p.shape, generator=gen))
        module.eval()
        x = torch.randn(2, 3, hw, hw, generator=gen)
        card = copy.deepcopy(module).to(dev)
        with torch.no_grad():
            want, want_taps = module(x, taps=True)
            got, got_taps = card(x.to(dev), taps=True)
        errs = {"logits": _rel_err(got.cpu().numpy(), want.numpy())}
        for tap in sorted(want_taps):
            errs[tap] = _rel_err(got_taps[tap].cpu().numpy(),
                                 want_taps[tap].numpy())
        worst = max(errs.values())
        if not np.isfinite(worst) or worst > ZOO_SMALL_TOL:
            fail(f"zoo {label} card vs CPU: {errs}")
        print(f"zoo {label} ({hw} px) card vs CPU: logits and "
              f"{len(errs) - 1} taps within {worst:.2e} of the CPU's "
              f"largest (bound {ZOO_SMALL_TOL:g})")


def zoo_forward_flops(torch, bundle, x) -> float:
    """FLOPs of one forward of ``x`` as torch's flop counter counts them
    from the shapes of its matmuls and convolutions (elementwise work,
    LayerNorm and softmax not counted)."""
    from torch.utils.flop_counter import FlopCounterMode

    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        bundle.apply(x)
    return float(counter.get_total_flops())


def zoo_head(torch, name, module):
    """The one ``nn.Linear`` of ``module`` with 1000 outputs: the head
    of every zoo family."""
    heads = [m for m in module.modules()
             if isinstance(m, torch.nn.Linear) and m.out_features == 1000]
    if len(heads) != 1:
        fail(f"zoo {name}: {len(heads)} linear layers of 1000 outputs")
    return heads[0]


def drive_zoo_name(torch, dev, out_dir, card, name) -> tuple:
    """One zoo name at full width with seeded random weights: its bundle
    built on the CPU, two images on the CPU and on the card (logits within
    ZOO_FULL_TOL of max |logit|, top-1 equal unless the CPU's top two lie
    within that bound); then its 1000-way head projected off the stream's
    mean head input (random weights put most images of the stream in one
    class, and then a mask that reads 1,0,1,0,... would not show that
    each image met its own prediction: the projection spreads them, and
    the even images must fall in two classes at least); ground truth from
    the card's own classes (even images right, odd ones wrong), the
    forward alone at B=100 (CUDA events, TFLOP/s, peak memory); the
    bundle freed; then the image finder through its entry point on the
    same stream, with the same head, launches counted, whose mask must
    read 1,0,1,0,... (end-to-end images a second, less the finder's own
    bundle build).  Returns (launches, the row)."""
    import statistics as st

    import numpy as np

    from xai_tpu_torch.data.imagenet import ImageNetValStream
    from xai_tpu_torch.models import get_bundle
    from xai_tpu_torch.runners import image_finder as fi
    from xai_tpu_torch.runners.common import normalize_input, predict_classes

    t0 = time.perf_counter()
    bundle = get_bundle(name, device="cpu")
    t_cpu_build = time.perf_counter() - t0
    hw, family = bundle.meta.img_hw, bundle.meta.family
    n_params = sum(p.numel() for p in bundle.module.parameters())
    items = list(ImageNetValStream("", hw, synthetic=ZOO_IMAGES))
    x2 = torch.stack([normalize_input(it.trans_img, family, "cpu")
                      for it in items[:2]]).permute(0, 3, 1, 2).contiguous()
    with torch.no_grad():
        want = bundle.apply(x2).numpy()
    bundle.module.to(dev)
    with torch.no_grad():
        got = bundle.apply(x2.to(dev)).cpu().numpy()
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max()) / scale
    top2 = np.sort(want, axis=1)[:, -2:]
    tie = (top2[:, 1] - top2[:, 0]) <= ZOO_FULL_TOL * scale
    same = got.argmax(1) == want.argmax(1)
    if not (np.isfinite(got).all() and np.isfinite(scale) and scale > 0):
        fail(f"zoo {name}: logits not finite ({scale})")
    if err > ZOO_FULL_TOL or not np.all(same | tie):
        fail(f"zoo {name} card vs CPU: {err:.2e} of max |logit| {scale:.3g}"
             f", top-1 {got.argmax(1)} vs {want.argmax(1)}")
    flops = zoo_forward_flops(torch, bundle, x2[:1].to(dev))

    xs = torch.stack([normalize_input(it.trans_img, family, dev)
                      for it in items])
    head = zoo_head(torch, name, bundle.module)
    sums = []
    hook = head.register_forward_hook(lambda m, i, o: sums.append(
        i[0].reshape(-1, i[0].shape[-1]).double().sum(0)))
    with torch.no_grad():
        for i in range(0, ZOO_IMAGES, 100):
            bundle.apply(xs[i:i + 100].permute(0, 3, 1, 2).contiguous())
    hook.remove()
    mu = (sum(sums) / ZOO_IMAGES).cpu()
    w = head.weight.detach().cpu().double()
    w_proj = (w - torch.outer(w @ mu, mu) / (mu @ mu)).float()
    head.weight.copy_(w_proj.to(dev))
    classes = []
    for i in range(0, ZOO_IMAGES, 100):
        classes += predict_classes(bundle, xs[i:i + 100])
    if len(set(classes[0::2])) < 2:
        fail(f"zoo {name}: the even images all fall in class {classes[0]} "
             "with the projected head; the mask would not test them")
    xb = xs[:100]
    torch.cuda.reset_peak_memory_stats(dev)
    predict_classes(bundle, xb)                     # warm
    times = [_event_s(torch, lambda: predict_classes(bundle, xb))[1]
             for _ in range(3)]
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    t_fwd = st.median(times)
    del bundle, xs, xb
    torch.cuda.empty_cache()

    d = os.path.join(out_dir, f"zoo_{name}")
    os.makedirs(d)
    gt = os.path.join(d, "ground_truth.txt")
    with open(gt, "w") as f:
        f.writelines(f"{c if i % 2 == 0 else (c + 1) % 1000}\n"
                     for i, c in enumerate(classes))
    args = fi.build_parser().parse_args(
        ["--model", name, "--synthetic", str(ZOO_IMAGES), "--batch_size",
         "100", "--ground_truth", gt, "--class_maps_dir", d])
    builds = []
    build = fi.build_bundle

    def timed_build(*a, **k):              # a spy: times the finder's own
        t = time.perf_counter()
        out = build(*a, **k)
        zoo_head(torch, name, out.module).weight.copy_(w_proj.to(dev))
        torch.cuda.synchronize()
        builds.append(time.perf_counter() - t)
        return out

    fi.build_bundle = timed_build
    try:
        t0 = time.perf_counter()
        mask, launches = run_path(
            torch, f"zoo_{name}",
            lambda: fi.find_correctly_classified(args, device=dev),
            NO_LAUNCHES)
        wall = time.perf_counter() - t0
    finally:
        fi.build_bundle = build
    on_disk = np.loadtxt(os.path.join(
        d, f"correctly_classified_{name}.txt")).tolist()
    want_mask = [1, 0] * (ZOO_IMAGES // 2)
    if mask.tolist() != want_mask or on_disk != want_mask:
        fail(f"zoo {name}: mask {mask.tolist()[:8]}... (file "
             f"{on_disk[:8]}...), expected 1,0,1,0,...")
    torch.cuda.empty_cache()
    row = {"name": name, "img_hw": hw, "params_m": n_params / 1e6,
           "gflop_per_image": flops / 1e9,
           "forward_images_per_s": 100 / t_fwd,
           "forward_ms_b100": t_fwd * 1e3,
           "tflops": flops * 100 / t_fwd / 1e12,
           "finder_images_per_s": ZOO_IMAGES / (wall - builds[0]),
           "finder_s": wall, "finder_build_s": builds[0],
           "cpu_build_s": t_cpu_build, "peak_gib_b100": peak,
           "card_vs_cpu": err, "classes": len(set(classes))}
    print(f"zoo {name}: {hw} px, {n_params / 1e6:.2f}M params, "
          f"{flops / 1e9:.2f} GFLOP an image; card vs CPU {err:.2e} of max "
          f"|logit| {scale:.3g}, top-1 equal"
          f"{'' if same.all() else ' (a tie within the bound)'}; forward "
          f"at B=100 {100 / t_fwd:.1f} images/s ({t_fwd * 1e3:.2f} ms, CUDA "
          f"events, {row['tflops']:.2f} TFLOP/s), peak {peak:.2f} GiB; "
          f"finder end to end {row['finder_images_per_s']:.1f} images/s "
          f"({ZOO_IMAGES} synthetic images in {wall:.3f} s, of it "
          f"{builds[0]:.3f} s building the bundle); mask 1,0,1,0,... "
          f"({row['classes']} classes among the images, projected head) on "
          f"{card}")
    return launches, row


def drive_zoo_paths(torch, dev, out_dir, card) -> dict:
    """Phase 4 and 6, the extended zoo: each of its 15 names outside the
    drivers' table through the image finder (drive_zoo_name), one model
    on the card at a time.  Prints a {"zoo": [...]} line of the rows.
    Returns the launches by path."""
    t0 = time.perf_counter()
    by_path, rows = {}, []
    for name in ZOO_NAMES:
        by_path[f"zoo_{name}"], row = drive_zoo_name(torch, dev, out_dir,
                                                     card, name)
        rows.append(row)
    print(json.dumps({"zoo": rows, "card": card}))
    print(f"zoo phase: {time.perf_counter() - t0:.1f} s for "
          f"{len(ZOO_NAMES)} names")
    return by_path


# --- multi-process runs and the profiler (ROADMAP A14) ---

# the two-process phase: (label, driver, flags) each worker runs with
# --shard_images (the sweep stripes its runs without it), and where the
# single-process run of the same flags is: (the label of the run in
# by_path, the directory of its result files under the run's out_dir)
TWO_PROCESS_RUNS = [
    ("pert_R101_ig", "pert", ["--model", "R101", "--attr_func", "ig",
                              "--synthetic", "2", "--image_count", "2"],
     "ig"),
    ("sanity_R101_ig", "sanity", ["--model", "R101", "--attr_func", "ig",
                                  "--synthetic", "2", "--image_count", "2"],
     "sanity_ig"),
    ("seg_R101_ig", "seg", ["--model", "R101", "--attr_func", "ig",
                            "--synthetic", "2"], "seg_ig"),
    ("seg_eval_TINY_R_grad", "seg_eval",
     ["--model", "TINY_R", "--method", "grad", "--synthetic", "4",
      "--acc_cutoff", "0"], "tiny_r_seg_eval_grad"),
    ("sweep_TINY_R", "sweep",
     ["--drivers", "pert", "--models", "TINY_R", "--methods", "grad,ig",
      "--synthetic", "2", "--image_count", "2"], "tiny_r_sweep"),
]
WORKER_TIMEOUT_S = 420
RUNTIME_ROWS = ("Attr Avg Runtime", "Total Runtime")


def driver_entry(driver: str):
    """(module, entry function) of a driver of the two-process phase."""
    from xai_tpu_torch.runners import evaluate_imagenet_seg as eg
    from xai_tpu_torch.runners import evaluate_perturbation as ep
    from xai_tpu_torch.runners import evaluate_sanity as es
    from xai_tpu_torch.runners import imagenet_seg_eval as ie
    from xai_tpu_torch.runners import sweep as sw

    mod = {"pert": ep, "sanity": es, "seg": eg, "seg_eval": ie,
           "sweep": sw}[driver]
    entry = {"pert": "evaluate_perturbation", "sanity": "evaluate_sanity",
             "seg": "evaluate_imagenet_seg", "seg_eval": "run",
             "sweep": "run_sweep"}[driver]
    return mod, getattr(mod, entry)


def result_files(run_dir: str, driver: str, flags: list) -> list:
    """The result files a run of the two-process phase writes."""
    def flag(name, default=None):
        return flags[flags.index(name) + 1] if name in flags else default

    model = flag("--model") or flag("--models")
    if driver == "sweep":
        return [os.path.join(run_dir, model, f"{m}_{flag('--image_count')}"
                             f"_images.csv")
                for m in flag("--methods").split(",")]
    if driver == "seg_eval":
        return [os.path.join(run_dir, f"{model}_{flag('--method')}.txt")]
    name = f"{flag('--attr_func')}_{flag('--image_count', '0')}_images"
    return [os.path.join(run_dir, model,
                         name + ("" if driver == "seg" else ".csv"))]


def read_result(path: str) -> dict:
    """A driver's CSV or TXT as {row: number}, runtime rows left out."""
    if not path.endswith(".csv"):
        return _read_seg_txt(path)
    with open(path) as f:
        return {r[0]: float(r[1]) for r in csv.reader(f)
                if r and r[0] not in RUNTIME_ROWS}


def two_process_worker(rank: int, port: int, out_dir: str, device: str,
                       runs: str) -> None:
    """One of the two processes of the two-process phase, started by
    :func:`check_two_processes` as ``python3 -c``: joins the gloo group on
    ``127.0.0.1:<port>`` (``multi_host.initialize``), runs each of
    ``runs`` (TWO_PROCESS_RUNS as JSON) with --shard_images on
    ``device``, each kernel
    counter zeroed just before a run and read just after, and prints one
    ``TWO_PROCESS {...}`` line: its rank, and for each run the dataset
    indices it attributed (its stripe), what the driver returned, its
    launches, the bn_act and layernorm launches its forwards should make
    (FusedPasses) and seconds (the sweep's stripe: the runs it
    took)."""
    import torch

    from xai_tpu_torch.parallel import multi_host
    from xai_tpu_torch.runners.common import resolve_device

    t_start = time.perf_counter()
    multi_host.initialize(f"127.0.0.1:{port}", 2, rank)
    print(f"two-process worker {rank}: torch.cuda.device_count() = "
          f"{torch.cuda.device_count()}", flush=True)
    dev = resolve_device(device)
    wrappers = kernel_wrappers()
    fused = fused_passes()
    out = {"rank": rank, "runs": {}}
    for label, driver, flags, _ in json.loads(runs):
        mod, entry = driver_entry(driver)
        shared = driver == "sweep"
        run_dir = os.path.join(out_dir, label + ("_shared" if shared
                                                 else f"_rank{rank}"))
        args = mod.build_parser().parse_args(
            flags + ([] if shared else ["--shard_images"])
            + ["--output_dir", run_dir])
        stripe = []
        generator = getattr(mod, "image_generator", None)
        if generator is not None:
            def spy(seed, index, device_, real=generator):
                stripe.append(index)
                return real(seed, index, device_)
            mod.image_generator = spy
        for w in wrappers.values():
            w.launches = 0
        fused.zero()
        t0 = time.perf_counter()
        try:
            returned = entry(args, device=dev)
        finally:
            if generator is not None:
                mod.image_generator = generator
        if dev.type == "cuda":
            torch.cuda.synchronize()
        if driver == "sweep":           # the sweep stripes its runs
            stripe = [r["attr_func"] for r in returned]
        out["runs"][label] = {
            "stripe": sorted(set(stripe)), "returned": returned,
            "launches": {n: w.launches for n, w in wrappers.items()},
            "want": fused.want(),
            "seconds": time.perf_counter() - t0}
    out["seconds"] = time.perf_counter() - t_start
    print("TWO_PROCESS " + json.dumps(out), flush=True)


def single_process_references(torch, dev, out_dir) -> dict:
    """The single-process TINY_R runs of the two-process phase (its R101
    runs are phase 4's), each through run_path with its launches: the
    sweep's two pert runs score one image a class of the first two
    (the quota at --image_count 2), each battery blur 1 and at 64 px
    ceil(65 / 45) = 2 reveals."""
    classes = model_classes(torch, dev, "TINY_R", 2)
    scored = 2 * len(set(classes))
    by_path = {}
    for label, driver, flags, single in TWO_PROCESS_RUNS:
        if not single.startswith("tiny_r"):
            continue
        mod, entry = driver_entry(driver)
        args = mod.build_parser().parse_args(
            flags + ["--output_dir", os.path.join(out_dir, single)])
        want = (dict(NO_LAUNCHES, blur_planes=scored,
                     reveal_batch=math.ceil(65 / 45) * scored)
                if driver == "sweep" else NO_LAUNCHES)
        _, by_path[single] = run_path(
            torch, single, lambda: entry(args, device=dev), want)
    return by_path


def check_two_processes(torch, dev, out_dir, by_path) -> dict:
    """Phase 7: two processes on the one card, joined by gloo on
    localhost, each driving TWO_PROCESS_RUNS with --shard_images
    (:func:`two_process_worker`).  Fails unless both exit 0 within
    WORKER_TIMEOUT_S; process 0's CSVs and TXTs are within 1e-4 of the
    single-process runs of the same flags (``by_path`` holds their
    launches; single_process_references makes the TINY_R ones), runtime
    rows aside; process 1 wrote no result file; both
    returned the same scores; the shared sweep manifest holds both runs
    ok; and the two processes' launches add up to the single-process
    run's.  Returns each process's launches, summed over its runs."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    here = os.path.dirname(os.path.abspath(__file__))
    two_dir = os.path.join(out_dir, "two_process")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    code = ("import sys; sys.path.insert(0, sys.argv[1]); import chip_smoke;"
            " chip_smoke.two_process_worker(int(sys.argv[2]), "
            "int(sys.argv[3]), *sys.argv[4:7])")
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-c", code, here, str(rank), str(port), two_dir,
         str(dev), json.dumps(TWO_PROCESS_RUNS)], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, env=env, cwd=here) for rank in (0, 1)]
    outs = []
    try:
        for rank, p in enumerate(procs):
            try:
                stdout, stderr = p.communicate(timeout=WORKER_TIMEOUT_S)
            except subprocess.TimeoutExpired:
                fail(f"two-process worker {rank} did not finish within "
                     f"{WORKER_TIMEOUT_S} s")
            print(stdout, end="")
            if p.returncode != 0:
                fail(f"two-process worker {rank} exited {p.returncode}: "
                     f"{stderr[-3000:]}")
            lines = [ln for ln in stdout.splitlines()
                     if ln.startswith("TWO_PROCESS ")]
            if len(lines) != 1:
                fail(f"two-process worker {rank} printed no result line")
            outs.append(json.loads(lines[0][len("TWO_PROCESS "):]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    wall = time.perf_counter() - t0

    launches = [{n: 0 for n in NO_LAUNCHES} for _ in outs]
    for label, driver, flags, single in TWO_PROCESS_RUNS:
        runs = [o["runs"][label] for o in outs]
        for total, run in zip(launches, runs):
            for n, c in run["launches"].items():
                total[n] += c
        summed = {n: sum(r["launches"][n] for r in runs)
                  for n in NO_LAUNCHES}
        # the fused passes launch as their forwards say: each process may
        # run forwards of its own beside its stripe's
        want = dict(by_path[single], **{
            n: sum(r["want"][n] for r in runs) for n in FUSED})
        if summed != want:
            fail(f"two-process {label}: the processes launched "
                 f"{[r['launches'] for r in runs]}, summed {summed}; the "
                 f"single-process run {by_path[single]}, fused passes "
                 f"{json.dumps({n: want[n] for n in FUSED})} by their "
                 f"forwards")
        if runs[0]["returned"] != runs[1]["returned"] and driver != "sweep":
            fail(f"two-process {label}: the processes returned "
                 f"{runs[0]['returned']} and {runs[1]['returned']}")
        if driver == "sweep":
            shared = os.path.join(two_dir, f"{label}_shared")
            with open(os.path.join(shared, "sweep_manifest.jsonl")) as f:
                manifest = [json.loads(line) for line in f]
            methods = flags[flags.index("--methods") + 1].split(",")
            if sorted((r["attr_func"], r["status"]) for r in manifest) != \
                    sorted((m, "ok") for m in methods) or [
                        [r["attr_func"] for r in run["returned"]]
                        for run in runs] != [[m] for m in methods]:
                fail(f"two-process {label}: manifest {manifest}")
            got_files = result_files(shared, driver, flags)
        else:
            rank1 = os.path.join(two_dir, f"{label}_rank1")
            if os.path.exists(rank1):
                fail(f"two-process {label}: process 1 wrote "
                     f"{os.listdir(rank1)}")
            got_files = result_files(os.path.join(two_dir, f"{label}_rank0"),
                                     driver, flags)
        want_files = result_files(os.path.join(out_dir, single), driver,
                                  flags)
        worst = 0.0
        for got_path, want_path in zip(got_files, want_files):
            got, want = read_result(got_path), read_result(want_path)
            err = max((abs(got[k] - want[k]) for k in want),
                      default=math.inf) if sorted(got) == sorted(want) \
                else math.inf
            if not err < 1e-4:
                fail(f"two-process {label}: {got_path} {got} against the "
                     f"single-process {want}")
            worst = max(worst, err)
        print(f"two-process {label}: stripes "
              f"{[r['stripe'] for r in runs]}, launches "
              f"{[r['launches'] for r in runs]} (single process "
              f"{by_path[single]}), seconds "
              f"{[round(r['seconds'], 3) for r in runs]}; process 0's "
              f"files within {worst:.2e} of the single-process run (bound "
              f"1e-4), process 1 wrote none")
    print(f"two-process phase: {wall:.1f} s wall, workers "
          f"{outs[0]['seconds']:.1f} / {outs[1]['seconds']:.1f} s from "
          f"start to result line")
    return {f"two_process_rank{o['rank']}": total
            for o, total in zip(outs, launches)}


# the profile phase: (model, attr_func); one synthetic image each, at
# --image_count 1000 (CLIP's random weights need it, clip_paths)
PROFILE_PATHS = [("R101", "ig"), ("VIT16", "rollout"), ("CLIP16", "eclip")]


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


def trace_summary(path: str, top: int = 8) -> dict:
    """A Chrome trace's device kernels: count, summed device time (and
    that of the port's blur and reveal kernels), the busy share of the
    traced window and of the kernels' own span, and the ``top`` kernels
    by summed time."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    by_name = {}
    for e in kernels:
        calls_us = by_name.setdefault(e["name"], [0, 0.0])
        calls_us[0] += 1
        calls_us[1] += e["dur"]
    spans = [(e["ts"], e["ts"] + e.get("dur", 0)) for e in events]
    k_spans = [(e["ts"], e["ts"] + e["dur"]) for e in kernels]
    busy = _busy_us(k_spans)
    window = max(e for _, e in spans) - min(s for s, _ in spans)
    k_window = (max(e for _, e in k_spans) - min(s for s, _ in k_spans)
                if k_spans else 0.0)
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][1])
    port = {k: sum(us for n, (_, us) in by_name.items() if k in n)
            for k in ("blur", "reveal")}
    return {"kernels": len(kernels), "kernel_us": sum(
        v[1] for v in by_name.values()), "port_kernel_us": port,
        "busy_us": busy,
        "window_us": window, "kernel_span_us": k_window,
        "names": list(by_name),
        "top": [{"name": n, "calls": c, "us": us}
                for n, (c, us) in ranked[:top]]}


def check_profiles(torch, dev, out_dir, card) -> dict:
    """Phase 8: evaluate_perturbation through ``main`` with --profile_dir
    on PROFILE_PATHS, one synthetic image each, and the same flags
    without it.  Fails unless each trace holds device kernels, the blur
    and reveal kernels among them, and the profiled CSV is within 1e-4 of
    the unprofiled one; prints the top kernels by summed device time and
    the busy share.  Returns the launches by path (blur 1, reveal 5
    each)."""
    from xai_tpu_torch.runners import evaluate_perturbation as ep

    by_path, rows = {}, []
    want = dict(NO_LAUNCHES, blur_planes=1, reveal_batch=REVEAL_PER_BATTERY)
    for model, attr in PROFILE_PATHS:
        label = f"profile_{model}_{attr}"
        flags = ["--model", model, "--attr_func", attr, "--synthetic", "1",
                 "--image_count", "1000"]
        d = os.path.join(out_dir, label)
        _, by_path[f"{label}_plain"] = run_path(
            torch, f"{label}_plain", lambda: ep.main(
                flags + ["--output_dir", os.path.join(d, "plain")],
                device=dev), want)
        t0 = time.perf_counter()
        _, by_path[label] = run_path(
            torch, label, lambda: ep.main(
                flags + ["--output_dir", os.path.join(d, "profiled"),
                         "--profile_dir", os.path.join(d, "trace")],
                device=dev), want)
        wall = time.perf_counter() - t0
        trace = os.path.join(d, "trace", f"{model}_{attr}_p0.trace.json")
        size = os.path.getsize(trace)
        s = trace_summary(trace)
        names = " ".join(s["names"])
        if not s["kernels"] or "blur" not in names or "reveal" not in names:
            fail(f"{label}: the trace holds {s['kernels']} device kernels "
                 f"(blur and reveal among them: {'blur' in names}, "
                 f"{'reveal' in names})")
        name = f"{attr}_1000_images.csv"
        got = read_result(os.path.join(d, "profiled", model, name))
        plain = read_result(os.path.join(d, "plain", model, name))
        err = max(abs(got[k] - plain[k]) for k in plain)
        if sorted(got) != sorted(plain) or not err < 1e-4:
            fail(f"{label}: profiled CSV {got}, unprofiled {plain}")
        print(f"{label}: traced run {wall:.3f} s wall (bundle build "
              f"included), trace {size / 2**20:.2f} MiB; {s['kernels']} "
              f"device kernels, summed {s['kernel_us'] / 1e3:.3f} ms; busy "
              f"{s['busy_us'] / 1e3:.3f} ms = "
              f"{100 * s['busy_us'] / s['window_us']:.2f} % of the traced "
              f"window ({s['window_us'] / 1e6:.3f} s), "
              f"{100 * s['busy_us'] / s['kernel_span_us']:.2f} % of the "
              f"kernels' span ({s['kernel_span_us'] / 1e3:.3f} ms); blur "
              f"{s['port_kernel_us']['blur']:.2f} us and reveal "
              f"{s['port_kernel_us']['reveal']:.2f} us of device time; CSV "
              f"within {err:.2e} of the unprofiled run; on {card}")
        for k in s["top"]:
            print(f"  {k['us'] / 1e3:10.3f} ms {k['calls']:6d} calls  "
                  f"{k['name'][:100]}")
        rows.append(dict(label=label, wall_s=wall, trace_bytes=size,
                         **{k: v for k, v in s.items() if k != "names"}))
    print(json.dumps({"profiles": rows}))
    return by_path


# the mesh phase's bounds: the tensor-parallel logits relative to max
# |logit|; the eval step's two means; the train step's loss and
# calibration, and its gradients relative to their size; batteries and the
# driver's CSV (tests/test_torch_mesh.py)
MESH_LOGIT_TOL = 1e-4
MESH_EVAL_TOL = 1e-5
MESH_TRAIN_TOL = 1e-4
MESH_GRAD_TOL = 1e-3
MESH_SCORE_TOL = 2e-3


def mesh_devices(torch, dev, n: int) -> list:
    """``n`` mesh entries: the visible cards in turn where there are two
    or more, else ``dev`` repeated (a virtual mesh)."""
    count = torch.cuda.device_count()
    if count < 2:
        return [dev] * n
    return [torch.device("cuda", i % count) for i in range(n)]


def _max_score_err(got: list, want: list) -> float:
    if [list(g) for g in got] != [list(w) for w in want]:
        return math.inf
    return max(abs(g[k] - w[k]) for g, w in zip(got, want) for k in w)


def check_device_guard(torch) -> None:
    """On a host of two or more cards, each kernel launched on card 1 must
    leave the caller's current device as it was (the wrappers' device
    guard around the C entries' cudaSetDevice)."""
    if torch.cuda.device_count() < 2:
        print("device guard: one card visible, could not check that a "
              "launch on another card keeps the current device")
        return
    from xai_tpu_torch.kernels.blur import blur_planes
    from xai_tpu_torch.kernels.bn_act import bn_act
    from xai_tpu_torch.kernels.layernorm import layernorm
    from xai_tpu_torch.kernels.quickshift import quickshift_parents
    from xai_tpu_torch.kernels.reveal import reveal_batch

    d1 = torch.device("cuda", 1)
    g = torch.Generator(d1).manual_seed(0)
    x = torch.rand(2, 3, 32, 32, device=d1, generator=g)
    flip = torch.randint(1, 33, (2, 32, 32), device=d1, generator=g,
                         dtype=torch.int32)
    steps = torch.arange(5, dtype=torch.int32, device=d1)
    launches = {
        "blur_planes": lambda: blur_planes(x[0]),
        "reveal_batch": lambda: reveal_batch(x, x * 0, flip, steps),
        "quickshift_parents": lambda: quickshift_parents(
            x.permute(0, 2, 3, 1).contiguous(), 0.5 / 36, 36.0, 0.5, w=6,
            wd=4),
        "bn_act": lambda: bn_act(x, x[0, :, 0, 0].contiguous(),
                                 x[1, :, 0, 0].contiguous(), x),
        "layernorm": lambda: layernorm(x, x[0, 0, 0].contiguous(),
                                       x[1, 0, 0].contiguous(), 1e-6)}
    before = torch.cuda.current_device()
    for name, launch in launches.items():
        launch()
        torch.cuda.synchronize(d1)
        if torch.cuda.current_device() != before:
            fail(f"device guard: {name} on cuda:1 left the current device "
                 f"{torch.cuda.current_device()}, was {before}")
    print(f"device guard: launches on cuda:1 kept the current device "
          f"cuda:{before}")


def check_mesh(torch, dev, out_dir, card) -> dict:
    """Phase 9: the in-process mesh at full width, on the visible cards
    when there are two or more, else a virtual mesh on ``dev``.  VIT16:
    the tensor-parallel model over two ranks against the whole one, the
    eval step on a 2x2 mesh, one train step on it, the tensor-parallel
    battery over two data rows; R101: the battery at B=6 over a 4x1 mesh
    and the --image_batch 4 driver over it, each against its one-device
    run.  Times each warm step, mesh against one device.  Returns the
    launches by path."""
    import numpy as np

    from xai_tpu_torch.parallel.mesh import (TensorParallelViT, make_mesh,
                                             vit_param_spec)
    from xai_tpu_torch.parallel.sharded_battery import sharded_battery_scores
    from xai_tpu_torch.methods.mas_calibrate import ADAM_B1
    from xai_tpu_torch.parallel.sharded_eval import (_ig_attr,
                                                     make_sharded_train_step,
                                                     sharded_eval_step)
    from xai_tpu_torch.runners import evaluate_perturbation as ep
    from xai_tpu_torch.runners.common import (build_bundle, default_blur,
                                              normalize_input)

    t0 = time.perf_counter()
    count = torch.cuda.device_count()
    kind = ("the visible cards" if count >= 2
            else f"a virtual mesh on {dev}: its times are overhead, not "
                 f"scaling")
    print(f"mesh phase: torch.cuda.device_count() = {count}; the meshes "
          f"are {kind}")
    check_device_guard(torch)
    one = make_mesh(devices=[dev])
    mesh22 = make_mesh(4, 2, devices=mesh_devices(torch, dev, 4))
    mesh41 = make_mesh(4, 1, devices=mesh_devices(torch, dev, 4))
    by_path, times = {}, {}

    bundle = build_bundle("VIT16", device=dev)
    module = bundle.module
    spec = vit_param_spec(module)
    g = torch.Generator(dev).manual_seed(12)
    xs = torch.randn(8, 3, 224, 224, device=dev, generator=g)
    targets = torch.randint(0, 1000, (8,), device=dev, generator=g)

    def tp_logits():
        tp = TensorParallelViT(module, mesh22.devices[0], spec)
        with torch.no_grad():
            return tp(xs[:4]), module(xs[:4])
    (got, whole), _ = run_path(torch, "mesh_vit16_tp_logits", tp_logits,
                               NO_LAUNCHES)
    err = float((got - whole).abs().max() / whole.abs().max())
    if not err <= MESH_LOGIT_TOL:
        fail(f"mesh: tensor-parallel VIT16 logits off by {err:.3e} of max "
             f"|logit|")
    print(f"mesh: tensor-parallel VIT16 (2 ranks) logits at B=4 within "
          f"{err:.3e} of max |logit| of the whole model (bound "
          f"{MESH_LOGIT_TOL})")

    steps = {"mesh": sharded_eval_step(module, mesh22, spec),
             "one": sharded_eval_step(module, one)}
    out = {}
    for name, step in steps.items():
        for _ in range(2):              # the first call warms up
            out[name], times[f"eval_{name}"] = _event_s(
                torch, lambda: step(xs, targets))
    for k in ("mean_target_prob", "accuracy"):
        err = abs(float(out["mesh"][k]) - float(out["one"][k]))
        if not err <= MESH_EVAL_TOL:
            fail(f"mesh: eval step {k} {float(out['mesh'][k])} on 2x2, "
                 f"{float(out['one'][k])} on one device")
    print(f"mesh: eval step at B=8 on 2x2 with the spec: "
          f"{ {k: float(v) for k, v in out['mesh'].items()} }, one device "
          f"{ {k: float(v) for k, v in out['one'].items()} } (bound "
          f"{MESH_EVAL_TOL})")

    # the float32 step, from a calibration where both gradients count: from
    # init_fn's (bias 0) the min-max leaves the loss invariant to scale but
    # for its 1e-8, so d loss / d scale is a rounding residue, which
    # Adam's first step (g / (|g| + 1e-8)) turns into a step of up to lr
    # either way; and a bias far outside the channel sums of the
    # attributions (VIT16's random weights give ~1e-3) leaves it invariant
    # to both.  So the step starts from a bias that folds |.| inside them,
    # as tests/test_torch_mesh.py's 0.1 does at its widths: minus a third
    # of the sums' 75th percentile.  Adam's first moment is 0.1 of the
    # gradient, so the gradient is held too, relative to its size.
    x4, t4 = xs[:4], targets[:4]
    sums = _ig_attr(module, x4, t4, 4).sum(1)
    bias0 = -float(torch.quantile(sums.flatten(), 0.75)) / 3
    res = {}
    for name, mesh, sp in (("mesh", mesh22, spec), ("one", one, None)):
        step, init = make_sharded_train_step(module, mesh, sp)
        for _ in range(2):              # the first call warms up
            calib, opt = init()
            calib["bias"] = torch.full_like(calib["bias"], bias0)
            (new, opt, loss), times[f"train_{name}"] = _event_s(
                torch, lambda: step(calib, opt, x4, t4))
        grads = [float(opt[k].mu) / (1 - ADAM_B1) for k in ("scale", "bias")]
        res[name] = ([float(loss), float(new["scale"]), float(new["bias"])],
                     grads)
    (got, g_got), (want, g_want) = res["mesh"], res["one"]
    err = max(abs(a - b) for a, b in zip(got, want))
    # a zero gradient would hold nothing
    g_err = max(abs(a - b) / abs(b) if b else math.inf
                for a, b in zip(g_got, g_want))
    if not (err <= MESH_TRAIN_TOL and g_err <= MESH_GRAD_TOL
            and all(map(math.isfinite, got + g_got))):
        fail(f"mesh: float32 train step from bias {bias0:.4e}: (loss, "
             f"scale, bias) {got} and gradients {g_got} on 2x2, {want} and "
             f"{g_want} on one device")
    print(f"mesh: float32 train step at B=4 on 2x2 with the spec from bias "
          f"{bias0:.4e}: (loss, scale, bias) {got} within {err:.3e} of one "
          f"device (bound {MESH_TRAIN_TOL}); d loss / d (scale, bias) "
          f"{g_got} within {g_err:.3e} of its size (bound {MESH_GRAD_TOL})")
    del res

    sals = np.random.RandomState(9).rand(8, 224, 224).astype(np.float32)
    x_hwc = xs.permute(0, 2, 3, 1).contiguous()
    blur = default_blur()
    battery_want = {1: dict(NO_LAUNCHES, blur_planes=1,
                            reveal_batch=REVEAL_PER_BATTERY)}
    for shards in (2, 4):
        battery_want[shards] = dict(
            NO_LAUNCHES, blur_planes=shards,
            reveal_batch=shards * REVEAL_PER_BATTERY)
    vit = {}
    for name, mesh, sp, want in (("mesh", mesh22, spec, battery_want[2]),
                                 ("one", None, None, battery_want[1])):
        label = f"mesh_vit16_battery_{name}"
        vit[name], by_path[label] = run_path(
            torch, label, lambda: sharded_battery_scores(
                bundle, x_hwc[:2], sals[:2], blur, mesh=mesh,
                param_spec=sp), want)
        _, times[f"vit_battery_{name}"] = _event_s(
            torch, lambda: sharded_battery_scores(
                bundle, x_hwc[:2], sals[:2], blur, mesh=mesh,
                param_spec=sp))
    err = _max_score_err(vit["mesh"], vit["one"])
    if not err <= MESH_SCORE_TOL:
        fail(f"mesh: tensor-parallel VIT16 battery {vit['mesh']} against "
             f"one device {vit['one']}")
    print(f"mesh: tensor-parallel VIT16 battery at B=2 over 2x2 within "
          f"{err:.3e} of one device (bound {MESH_SCORE_TOL})")
    del bundle, module, xs, x_hwc

    r101 = build_bundle("R101", device=dev)
    imgs = np.random.RandomState(10).rand(6, 224, 224, 3).astype(np.float32)
    rx = torch.stack([normalize_input(im, "cnn", dev) for im in imgs])
    rt = [3, 1, 4, 1, 5, 9]
    res = {}
    for name, mesh, want in (("mesh", mesh41, battery_want[4]),
                             ("one", None, battery_want[1])):
        label = f"mesh_r101_battery_{name}"
        res[name], by_path[label] = run_path(
            torch, label, lambda: sharded_battery_scores(
                r101, rx, sals[:6], blur, targets=rt, mesh=mesh), want)
        _, times[f"r101_battery_{name}"] = _event_s(
            torch, lambda: sharded_battery_scores(
                r101, rx, sals[:6], blur, targets=rt, mesh=mesh))
    err = _max_score_err(res["mesh"], res["one"])
    if not err <= MESH_SCORE_TOL:
        fail(f"mesh: R101 battery over 4x1 {res['mesh']} against one "
             f"device {res['one']}")
    print(f"mesh: R101 battery at B=6 over 4x1 (shards 2/2/1/1) within "
          f"{err:.3e} of one device (bound {MESH_SCORE_TOL})")
    del r101, rx

    label = "mesh_r101_ig_b4"
    flags = ["--model", "R101", "--attr_func", "ig", "--image_batch", "4",
             "--synthetic", "4", "--image_count", "4000", "--output_dir",
             os.path.join(out_dir, label)]
    real_mesh, ep.battery_mesh = ep.battery_mesh, lambda d, b: mesh41
    try:
        _, by_path[label] = run_path(
            torch, label, lambda: ep.evaluate_perturbation(
                ep.build_parser().parse_args(flags), device=dev),
            battery_want[4])
    finally:
        ep.battery_mesh = real_mesh
    got = read_result(os.path.join(out_dir, label, "R101",
                                   "ig_4000_images.csv"))
    want = read_result(os.path.join(out_dir, "ig_b4", "R101",
                                    "ig_4000_images.csv"))
    err = max((abs(got[k] - want[k]) for k in want), default=math.inf) \
        if sorted(got) == sorted(want) else math.inf
    if not err <= MESH_SCORE_TOL:
        fail(f"mesh: the driver's CSV over 4x1 {got} against phase 4's "
             f"one-card {want}")
    print(f"mesh: evaluate_perturbation R101 ig --image_batch 4 over 4x1 "
          f"within {err:.3e} of phase 4's one-card CSV (bound "
          f"{MESH_SCORE_TOL})")
    print(f"mesh phase timing, warm, CUDA events, ms (mesh / one device; "
          f"{'real cards' if count >= 2 else 'virtual: overhead, not scaling'}"
          f"): "
          + ", ".join(f"{k} {times[k + '_mesh'] * 1e3:.3f} / "
                      f"{times[k + '_one'] * 1e3:.3f}"
                      for k in ("eval", "train", "vit_battery",
                                "r101_battery"))
          + f" on {card}")
    print(f"mesh phase: {time.perf_counter() - t0:.1f} s")
    return by_path


# --- the library entry point: the three walkthroughs (ROADMAP A16) ---

# each walkthrough as `python -m` runs it (runpy), in a process of its own,
# its launches counted from 0 at its start and read at its end; its
# seconds (the walkthrough's own, bundle build included) and the card's
# peak memory beside them
WALK_RUNNER = r"""
import json, runpy, sys, time
import torch
import chip_smoke
from xai_tpu_torch.kernels import blur, bn_act, layernorm, quickshift, reveal
fused = chip_smoke.fused_passes()
module, *argv = sys.argv[1:]
sys.argv = [module, *argv]
t0 = time.perf_counter()
runpy.run_module(module, run_name="__main__", alter_sys=True)
torch.cuda.synchronize()
print("WALKTHROUGH " + json.dumps({
    "s": time.perf_counter() - t0,
    "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
    "launches": {"blur_planes": blur.blur_planes.launches,
                 "reveal_batch": reveal.reveal_batch.launches,
                 "quickshift_parents":
                     quickshift.quickshift_parents.launches,
                 "bn_act": bn_act.bn_act.launches,
                 "layernorm": layernorm.layernorm.launches},
    "want": fused.want()}))
"""
WALK_TIMEOUT_S = 300
# MDA's rescoring (methods/mda.py find_deletion_patches): an insertion and
# a deletion pass of 225 curve points in chunks of 25
MDA_RESCORE_REVEALS = 2 * math.ceil((224 + 1) / 25)
# the ViT walkthrough's MDA patches
WALK_MDA_PATCHES = 16


def walkthroughs(out_dir: str) -> list:
    """(label, module, flags, launches, what each run must print) of the
    three walkthroughs at full width: R50 at 224 px (4 batteries), VIT16
    with MDA (at klen 31: the insertion search's start and the
    rescoring's substrate, one blur launch each, and the rescoring's
    reveals) and CLIP16 (no kernel)."""
    return [
        ("walk_cnn", "xai_tpu_torch.examples.cnn_example",
         ["--model", "R50", "--out", os.path.join(out_dir, "cnn.png")],
         {"blur_planes": 4, "reveal_batch": 4 * REVEAL_PER_BATTERY,
          "quickshift_parents": 0}, ("MAS_ins=", 4)),
        ("walk_vit", "xai_tpu_torch.examples.vit_example", ["--with_mda"],
         {"blur_planes": 2, "reveal_batch": MDA_RESCORE_REVEALS,
          "quickshift_parents": 0}, ("map sum", 6)),
        ("walk_clip", "xai_tpu_torch.examples.clip_example", [],
         dict(NO_LAUNCHES), ("[P,P]=(14, 14)", 4)),
    ]


def write_walk_images(out_dir: str) -> tuple:
    """An RGB JPEG of 400x300 (non-square: the resize and the crop act)
    and an L-mode PNG, from np.random.RandomState(0)."""
    import numpy as np
    from PIL import Image

    rs = np.random.RandomState(0)
    jpg = os.path.join(out_dir, "walk.jpg")
    Image.fromarray((rs.rand(300, 400, 3) * 255).astype(np.uint8),
                    "RGB").save(jpg, "JPEG")
    png = os.path.join(out_dir, "walk_l.png")
    Image.fromarray((rs.rand(300, 400) * 255).astype(np.uint8),
                    "L").save(png, "PNG")
    return jpg, png


def check_walk_input(torch, dev, jpg, png) -> None:
    """load_and_preprocess on the card: the JPEG as a normalized [1, 224,
    224, 3] input, the L image refused with None."""
    import numpy as np

    from xai_tpu_torch.ops import load_and_preprocess

    if load_and_preprocess(png, device=dev) is not None:
        fail("load_and_preprocess accepted an L-mode image")
    trans, x = load_and_preprocess(jpg, device=dev)
    if (trans.shape != (224, 224, 3) or not 0 <= trans.min() <= trans.max()
            <= 1 or tuple(x.shape) != (1, 224, 224, 3)
            or x.device.type != "cuda" or not bool(torch.isfinite(x).all())):
        fail(f"load_and_preprocess on the JPEG: {trans.shape}, "
             f"{tuple(x.shape)} on {x.device}")
    print(f"load_and_preprocess: {os.path.basename(jpg)} (400x300 RGB) -> "
          f"[1, 224, 224, 3] on {x.device}, mean {float(x.mean()):.4f}; "
          f"{os.path.basename(png)} (L) -> None")


def _printed_numbers(text: str, marker: str) -> list:
    """The numbers on each line of ``text`` that holds ``marker``."""
    import re

    number = r"[-+]?(?:\d+\.?\d*(?:e[-+]?\d+)?|nan|inf)"
    return [[float(v) for v in re.findall(number, ln.split(marker, 1)[1])]
            for ln in text.splitlines() if marker in ln]


def drive_walkthroughs(torch, dev, out_dir, card) -> dict:
    """Phase 10, the library entry point: the two image files, then each
    walkthrough at full width on the JPEG through its module's main, as
    `python -m` runs it, in a process of its own (WALK_RUNNER).  Each must
    exit 0, print its maps' or scores' lines with finite numbers and
    launch each kernel as walkthroughs() says (bn_act and layernorm as
    FusedPasses counts its forwards).  Returns the launches by
    path."""
    here = os.path.dirname(os.path.abspath(__file__))
    jpg, png = write_walk_images(out_dir)
    check_walk_input(torch, dev, jpg, png)
    by_path = {}
    for label, module, flags, want, (marker, lines) in walkthroughs(out_dir):
        cmd = [sys.executable, "-c", WALK_RUNNER, module, "--image", jpg,
               "--device", str(dev), *flags]
        t0 = time.perf_counter()
        try:
            r = subprocess.run(cmd, cwd=here, capture_output=True, text=True,
                               timeout=WALK_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            fail(f"{label} did not finish within {WALK_TIMEOUT_S} s")
        wall = time.perf_counter() - t0
        print(r.stdout, end="")
        if r.returncode != 0:
            fail(f"{label} exited {r.returncode}: {r.stderr[-3000:]}")
        rec = [ln for ln in r.stdout.splitlines()
               if ln.startswith("WALKTHROUGH ")]
        if len(rec) != 1:
            fail(f"{label} printed no WALKTHROUGH line")
        rec = json.loads(rec[0][len("WALKTHROUGH "):])
        nums = _printed_numbers(r.stdout, marker)
        if len(nums) != lines or not all(
                v and all(math.isfinite(x) for x in v) for v in nums):
            fail(f"{label}: {len(nums)} lines with {marker!r} ({lines} "
                 f"expected) or a number not finite: {nums}")
        want = dict(want, **rec["want"])
        if rec["launches"] != want:
            fail(f"the {label} path launched {rec['launches']}, expected "
                 f"{want}")
        by_path[label] = rec["launches"]
        print(f"{label} path: {wall:.3f} s wall, {rec['s']:.3f} s in the "
              f"walkthrough (bundle build included), peak "
              f"{rec['peak_gib']:.2f} GiB, launches "
              f"{json.dumps(rec['launches'])} on {card}")
    return by_path


def check_walkthrough_reference(torch, dev):
    """Phase 5, the walkthroughs' ``run`` card vs CPU on small models:
    the CNN's on TINY_R at 32 px (an input of check_batch_reference, whose
    ReLU inputs stay clear of zero), its four saliencies within 1e-4 and
    its battery scores within 2e-3; the ViT's on a 5-block test ViT at 32
    px (start_layer 4 of bidirectional weights a block), its five maps
    within 1e-4 and MDA at 16 patches within 1e-4 where its picks agree
    (else the first flipped pick must be a rounding-level tie); the
    CLIP's on xai_tpu's tiny CLIP, its four maps within 1e-4."""
    import numpy as np

    from xai_tpu_torch.examples import clip_example, cnn_example, vit_example
    from xai_tpu_torch.models import vit as tvit
    from xai_tpu_torch.models.common import ModelBundle, ModelMeta
    from xai_tpu_torch.runners.common import build_bundle, normalize_input

    cpu = torch.device("cpu")
    img = np.random.RandomState(9).rand(3, 32, 32, 3).astype(np.float32)[0]
    x_vit = np.random.RandomState(2).randn(32, 32, 3).astype(np.float32)
    trans = np.random.RandomState(3).rand(32, 32, 3).astype(np.float32)
    cfg = tvit.ViTConfig(**dict(VIT32PX, depth=5))
    runs = {}
    for d in (dev, cpu):
        log = io.StringIO()
        with contextlib.redirect_stdout(log):
            cnn = cnn_example.run(build_bundle("TINY_R", seed=1, device=d),
                                  normalize_input(img, "cnn", d))
            vit = ModelBundle(
                ModelMeta(name="vit5", family="vit", img_hw=32,
                          num_classes=16, num_patches=cfg.grid,
                          batch_size=8, mean=(0.5,) * 3, std=(0.5,) * 3),
                tvit.init_random(tvit.VisionTransformer(cfg), 0).to(d))
            with spied_mda_searches() as searches:
                vmaps = vit_example.run(vit, torch.as_tensor(x_vit,
                                                             device=d),
                                        trans, with_mda=True,
                                        patch_count=WALK_MDA_PATCHES)
            clip = tiny_clip(torch, d)
            cmaps = clip_example.run(
                clip, torch.as_tensor(x_vit, device=d),
                clip.text_embeddings[:1],
                torch.tensor(CLIP_TOKS[:1], device=d))
        runs[d.type] = cnn, vit, vmaps, searches, cmaps
    (cnn_g, _, vit_g, srch_g, clip_g) = runs["cuda"]
    (cnn_c, vit_c, vitm_c, srch_c, clip_c) = runs["cpu"]
    errs = {}
    for name, (sal, scores) in cnn_g.items():
        errs[f"cnn {name}"] = _rel_err(sal, cnn_c[name][0])
        worst = max(abs(scores[k] - cnn_c[name][1][k]) for k in scores)
        if not (all(math.isfinite(v) for v in scores.values())
                and worst < 2e-3):
            fail(f"CNN walkthrough {name} battery card vs CPU: {worst}")
    flip = None
    for name in vit_g:
        if name == "MDA":
            target = int(np.argmax(vit_c.apply(torch.as_tensor(
                x_vit).permute(2, 0, 1)[None]).detach().numpy()))
            flip = first_flipped_search(vit_c, srch_g, srch_c, target,
                                        "ViT walkthrough MDA")
            if flip is not None:
                continue
        errs[f"vit {name}"] = _rel_err(vit_g[name], vitm_c[name])
    errs.update({f"clip {n}": _rel_err(m, clip_c[n])
                 for n, m in clip_g.items()})
    if not all(e < 1e-4 for e in errs.values()):
        fail(f"walkthroughs card vs CPU: {errs}")
    print("walkthroughs' run card vs CPU, float32 rel err (< 1e-4; battery "
          "scores < 2e-3): " + ", ".join(f"{k} {v:.3g}"
                                         for k, v in errs.items())
          + ("" if flip is None else
             f"; MDA: a rounding-level tie flipped at {flip}"))


@contextlib.contextmanager
def timed_phase(phases: dict, name: str):
    """Adds the block's wall seconds to ``phases[name]`` and prints
    them."""
    t0 = time.perf_counter()
    yield
    phases[name] = phases.get(name, 0.0) + time.perf_counter() - t0
    print(f"phase {name}: {phases[name]:.1f} s")


def main() -> None:
    t_start = time.perf_counter()
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

    phases = {}
    with timed_phase(phases, "kernel build"):
        report = _build.build()
    print(f"kernel build: {sorted(report) or 'nothing (already built)'}")
    for name, r in report.items():
        for line in r["log"].splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    img = np.random.RandomState(0).rand(224, 224, 3)
    x_hwc = normalize(torch.as_tensor(img, dtype=torch.float32, device=dev),
                      IMAGENET_MEAN, IMAGENET_STD)
    with timed_phase(phases, "3 kernels"):
        rows = check_kernels(torch, dev, x_hwc)
        rows.append(check_quickshift(torch, dev))
        rows.append(check_bn_act(torch, dev))
        rows.append(check_layernorm(torch, dev))

    by_path = {}
    with tempfile.TemporaryDirectory() as out_dir:
        with timed_phase(phases, "4 CNN paths"):
            classes = synthetic_classes(torch, dev, 8)
            for label, *path in MAIN_PATHS:
                by_path[label] = run_main_path(torch, dev, out_dir, label,
                                               *path)
            by_path.update(drive_driver_paths(torch, dev, out_dir, classes,
                                              have))
        with timed_phase(phases, "4 ViT paths"):
            for label, *path in VIT_PATHS:
                by_path[label] = run_main_path(torch, dev, out_dir, label,
                                               *path)
            by_path.update(drive_vit_driver_paths(torch, dev, out_dir, have))
        with timed_phase(phases, "4 ViT slice-2 paths"):
            for label, *path in SLICE2_PATHS:
                by_path[label] = run_slice2_path(torch, dev, out_dir, label,
                                                 *path)
            by_path["vit16_MDA_confident"] = run_slice2_path(
                torch, dev, out_dir, "vit16_MDA_confident",
                ["--attr_func", "MDA"], 1, 1, 1, "VIT16", confident=True)
            by_path.update(drive_slice2_driver_paths(torch, dev, out_dir))
        with timed_phase(phases, "4 CLIP paths"):
            k16, clip_classes = two_class_images(torch, dev, "CLIP16")
            k32, _ = two_class_images(torch, dev, "CLIP32")
            for label, *path, scored in clip_paths(k16, k32):
                by_path[label] = run_main_path(torch, dev, out_dir, label,
                                               *path, min_scored=scored)
            by_path.update(drive_clip_driver_paths(torch, dev, out_dir,
                                                   clip_classes, have))
        with timed_phase(phases, "4 zoo paths"):
            by_path.update(drive_zoo_paths(torch, dev, out_dir, card))
        with timed_phase(phases, "7 two processes"):
            by_path.update(single_process_references(torch, dev, out_dir))
            by_path.update(check_two_processes(torch, dev, out_dir,
                                               by_path))
        with timed_phase(phases, "8 profiles"):
            by_path.update(check_profiles(torch, dev, out_dir, card))
        with timed_phase(phases, "9 mesh"):
            by_path.update(check_mesh(torch, dev, out_dir, card))
        with timed_phase(phases, "10 walkthroughs"):
            by_path.update(drive_walkthroughs(torch, dev, out_dir, card))
    for name, check in (
            ("5 TINY_R", lambda: check_small_reference(torch, dev)),
            ("5 TINY_R batched", lambda: check_batch_reference(torch, dev)),
            ("5 CNN family", lambda: check_a8_reference(torch, dev)),
            ("5 TINY_R drivers", lambda: check_tiny_drivers(torch, dev)),
            ("5 ViT", lambda: check_vit_reference(torch, dev)),
            ("5 ViT drivers", lambda: check_tiny_vit_drivers(torch, dev)),
            ("5 ViT slice 2", lambda: check_slice2_reference(torch, dev,
                                                            have)),
            ("5 CLIP", lambda: check_clip_reference(torch, dev)),
            ("5 zoo", lambda: check_zoo_reference(torch, dev)),
            ("5 walkthroughs", lambda: check_walkthrough_reference(torch,
                                                                  dev))):
        with timed_phase(phases, name):
            check()
    with timed_phase(phases, "6 CNN timing"):
        bundle = time_warm_image(torch, dev, card)
        time_warm_batch(torch, dev, card, bundle)
        time_warm_a8(torch, dev, card, bundle)
        time_warm_drivers(torch, dev, card, bundle)
        del bundle
    with timed_phase(phases, "6 ViT timing"):
        time_warm_vit(torch, dev, card)
        time_warm_slice2(torch, dev, card)
    with timed_phase(phases, "6 CLIP timing"):
        time_warm_clip(torch, dev, card)

    for row in rows:
        name = row["name"]
        row["launches"] = sum(p[name] for p in by_path.values())
        row["launches_by_path"] = {a: p[name] for a, p in by_path.items()}
        lib = ("none" if row["library_ms"] is None
               else f"{row['library_ms'] * 1e3:.2f} us")
        print(f"{name}: kernel {row['ms'] * 1e3:.2f} us, plain "
              f"{row['plain_ms'] * 1e3:.2f} us, library {lib}, bound "
              f"{row['bound_ms'] * 1e3:.3f} us ({row['bound_by']}) on {card}")
    print(json.dumps({"phases_s": phases}))
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s from start "
          f"to the result lines")
    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
