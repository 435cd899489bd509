"""Flagship driver: attribution -> 10-metric perturbation battery -> CSV.

Counterpart of ``xai_tpu/runners/evaluate_perturbation.py`` with the same
flags and output layout (the reference's
XAI_Survey/evaluations/evaluatePerturbation.py).  ``--cuda_num N`` selects
``cuda:N``; ``--synthetic N`` substitutes a deterministic random image
stream when no ImageNet directory is available.

Each image gets its own ``torch.Generator`` on the model's device, seeded
from ``(--seed, image index)``: the counterpart of xai_tpu's
``fold_in(PRNGKey(seed), index)``.  Its draws (LIME's sample rows,
SmoothGrad's noise, GradientShap's baseline and alphas, Shapley's
permutations, RISE's masks) differ from JAX's threefry draws by
construction; the parity tests inject the same draws into both packages.

Per-image flow (reference :520-599): sorted val stream -> correctly-
classified filter -> sanity gates (blur/black predictions) -> class-balance
quota -> attribution via the registry (every CNN, ViT and CLIP method of
xai_tpu's tables; a CLIP image gets its target's caption, ``clip_extras``)
-> run_battery (3 reveal passes fed by the reveal kernel) ->
accumulate -> CSV.  ``--image_batch N`` gathers N kept images and runs
one batched attribution (``methods/batch.py``) and one batched battery
(``parallel/sharded_battery.py``) for them, sharded over
:func:`battery_mesh` (one card: the whole batch on it); rise and xrai,
which have no batched form, attribute the batch's images one by one
through the registry, and a partial last batch goes image by image with
its stored targets.  Both paths go through :func:`kept_step`, the public
step over kept images.
``--attr_dtype bf16`` runs the attribution sweeps on a bf16 copy of the
model, on both paths for a CNN and on the batched path for a ViT or CLIP;
image by image, only TIS, VIT_CX, MDA and MDA_dense among the ViT and
CLIP names take it (their scoring forwards), as in xai_tpu.  ``--save_maps`` writes every scored image's map to
``<output_dir>/<model>_<attr_func>_maps.h5`` (``data/voc.py
ExplanationsHDF5``; it needs ``h5py``).

``--shard_images`` under a process group (``parallel/multi_host.py
initialize``): every process walks the whole stream, its gates and the
class quota, and keeps the same images; the kept images are striped over
the processes by kept rank, each attributes and scores its own, the
score sums and attribution seconds meet in ``allreduce_sums``, and only
process 0 writes the CSV.  Every process returns the global means.
``--profile_dir D`` (through :func:`main`) wraps the whole run, the
bundle's build included, in ``torch.profiler`` (CPU, and CUDA on a card)
and writes the Chrome trace ``D/<model>_<attr_func>_p<process
index>.trace.json``.

Run: ``python -m xai_tpu_torch.runners.evaluate_perturbation --model R101
--attr_func ig --synthetic 2 --image_count 2`` (or any other CNN name:
lime, gig, agi, gc, gbp, ggc, gs, fa, occ, shap, rise, xrai; or
``--model VIT16`` / ``VIT32`` with attn, grad, cam_attn, n_rollout,
rollout, t_attn, attn_ig, attn_attr, bi_attn, InFlow, t_attr, TIS,
VIT_CX, MDA, MDA_dense; or ``--model CLIP16`` / ``CLIP32`` with eclip,
eclip_nograd, eclip_wo, maskclip, grad_cam, selfattn, game, rollout,
lrp, m2ib, surgery, rise; or any other name of the extended zoo, such
as ``--model swin_base --attr_func ig``, which takes the family of its
bundle's meta (``runners/common.py``); add
``--image_batch 4 --attr_dtype bf16`` for the batched bf16 path).
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from ..data.classmaps import load_correct_mask
from ..data.imagenet import ImageNetValStream
from ..data.voc import ExplanationsHDF5, require_h5py
from ..metrics.curves import run_battery
from ..parallel import multi_host
from ..parallel.mesh import Mesh, canonical_device, make_mesh
from ..parallel.sharded_battery import sharded_battery_scores
from ..registry import get_attribution
from ..utils.trace import span
from .common import (ATTR_DTYPES, attr_context, batch_attribute,
                     build_bundle, default_blur, image_gates,
                     image_generator, model_entry, normalize_input,
                     resolve_device, write_result_csv)


class _MapStore:
    """The ``--save_maps`` writer: one dataset a scored image, with its
    target and original prediction, in a file opened at the first map
    (xai_tpu's ``write_map``)."""

    def __init__(self, args):
        self.path = os.path.join(args.output_dir,
                                 f"{args.model}_{args.attr_func}_maps.h5")
        self.store = None

    def write(self, p, saliency) -> None:
        if self.store is None:
            os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
            self.store = ExplanationsHDF5(self.path, mode="w")
        self.store.write(p["name"], saliency, target=p["target"],
                         original_pred=p["original_pred"])

    def close(self) -> None:
        if self.store is not None:
            self.store.close()


def _accumulate(result, scores) -> None:
    for k, v in scores.items():
        result[k] = result.get(k, 0.0) + v


def kept_step(bundle, family, pend, blur, attr_func, dtype=None,
              mesh=None):
    """The driver's step over kept images ``pend`` (dicts with ``x``,
    ``trans_img``, ``target`` and ``generator``), under the span ``step``:
    one image through the registry and ``run_battery``; more through
    ``batch_attribute`` and ``sharded_battery_scores`` on ``mesh``.
    Returns (``[B, H, W]`` saliencies, one 10-score dict an image, the
    attribution seconds); each part returns host numpy, so the step's
    device work is done when it returns."""
    with span("step"):
        if len(pend) == 1:
            p = pend[0]
            t = time.time()
            sals = get_attribution(family, attr_func,
                                   attr_context(bundle, p, dtype))[None]
            attr_dt = time.time() - t
            scores = [run_battery(bundle.apply, p["x"], sals[0], blur,
                                  chunk=45, target=p["target"])]
        else:
            sals, attr_dt = batch_attribute(bundle, family, attr_func, pend,
                                            dtype)
            scores = sharded_battery_scores(
                bundle, torch.stack([p["x"] for p in pend]), sals, blur,
                chunk=45, targets=[p["target"] for p in pend], mesh=mesh)
        return sals, scores, attr_dt


def _score_image(bundle, family, p, blur, result, args, maps=None):
    """Attribution and battery of one kept image, image by image.
    Returns (its scores, the attribution seconds)."""
    sals, (scores,), attr_dt = kept_step(bundle, family, [p], blur,
                                         args.attr_func,
                                         ATTR_DTYPES[args.attr_dtype])
    if maps is not None:
        maps.write(p, sals[0])
    _accumulate(result, scores)
    return scores, attr_dt


# the fewest images a card's data shard of the batched battery takes: a
# shard's battery launches as many kernels as a whole batch's, and the
# host threads launching them contend, so shards of one image are
# host-bound (R101 at --image_batch 4 ran slower over four H100s than on
# one; at 8, two images a card, faster: tools/mesh_scaling_probe.py)
MIN_SHARD_IMAGES = 2


def battery_mesh(device, batch: int) -> Mesh:
    """The mesh of the batched battery, xai_tpu's ``make_mesh(model_axis=1)``
    (evaluate_perturbation.py:80).  In one process: every visible card,
    ``device``'s first (it holds the bundle), when a ``batch`` gives each
    card ``MIN_SHARD_IMAGES`` images.  Else, under a process group of more
    than one process (so that no two processes share a card), on a CPU
    device or on a host of one card: ``device`` alone, 1x1."""
    device = canonical_device(device)
    cards = [device]
    if device.type == "cuda" and multi_host.process_count() == 1:
        cards += [torch.device("cuda", i)
                  for i in range(torch.cuda.device_count())
                  if i != device.index]
    if batch < MIN_SHARD_IMAGES * len(cards):
        cards = cards[:1]
    return make_mesh(devices=cards)


def _flush_batch(bundle, family, pend, blur, result, args, mesh,
                 maps=None) -> float:
    """Batched attribution and batched battery for a full image batch, the
    battery sharded over ``mesh``.  Returns the attribution seconds."""
    sals, all_scores, attr_dt = kept_step(bundle, family, pend, blur,
                                          args.attr_func,
                                          ATTR_DTYPES[args.attr_dtype], mesh)
    if maps is not None:
        for p, s in zip(pend, sals):
            maps.write(p, s)
    for p, scores in zip(pend, all_scores):
        _accumulate(result, scores)
        if args.verbose:
            print(f"[batch] {p['name']} MAS_ins={scores['MAS_ins']:.4f}")
    pend.clear()
    return attr_dt


def evaluate_perturbation(args, device=None) -> dict:
    """Run the driver; ``device`` defaults to ``cuda:<--cuda_num>``."""
    if args.save_maps:
        require_h5py("--save_maps")
    device = resolve_device(device or f"cuda:{args.cuda_num}")
    family, _ = model_entry(args.model)
    bundle = build_bundle(args.model, args.params_path, device=device)
    blur = default_blur()
    mesh = (battery_mesh(device, args.image_batch)
            if args.image_batch > 1 else None)

    correct = load_correct_mask(args.class_maps_dir, args.model) \
        if args.class_maps_dir else None

    num_classes = 1000
    images_per_class = int(np.ceil(args.image_count / num_classes))
    classes_used = [0] * num_classes

    stream = ImageNetValStream(args.dataset_path,
                               img_hw=bundle.meta.img_hw,
                               synthetic=args.synthetic)
    # plain-dict accumulation: the reference's `Counter +=` silently drops
    # keys whose running sum is <= 0; we keep every metric column
    result = {}
    images_used = 0
    attr_time = 0.0
    batch_buf = []
    maps = _MapStore(args) if args.save_maps else None
    t0 = time.time()
    gating = not (args.synthetic or args.skip_gates)
    shard = args.shard_images and multi_host.process_count() > 1
    pidx, pcount = multi_host.process_index(), multi_host.process_count()
    kept_rank = 0

    for item in stream:
        if images_used == args.image_count:
            break
        if correct is not None and correct[item.index] == 0:
            continue
        x = normalize_input(item.trans_img, family, device)
        target, original_pred, ok = image_gates(bundle, x, blur,
                                                gates=gating)
        if not ok and gating:
            continue
        if classes_used[target] == images_per_class:
            continue
        classes_used[target] += 1
        # another process's image still counts toward the shared
        # denominator and the loop's break
        mine = not shard or kept_rank % pcount == pidx
        kept_rank += 1
        images_used += 1
        if not mine:
            continue
        p = {"x": x, "trans_img": item.trans_img, "name": item.name,
             "target": target, "original_pred": original_pred,
             "generator": image_generator(args.seed, item.index, device)}

        if args.image_batch > 1:
            batch_buf.append(p)
            if len(batch_buf) == args.image_batch:
                attr_time += _flush_batch(bundle, family, batch_buf, blur,
                                          result, args, mesh, maps)
            continue

        scores, attr_dt = _score_image(bundle, family, p, blur, result, args,
                                       maps)
        attr_time += attr_dt
        if args.verbose:
            print(f"[{images_used}/{args.image_count}] {item.name} "
                  f"cls={target} MAS_ins={scores['MAS_ins']:.4f}")

    # the partial last batch, one image at a time with its stored target
    # (the batched path needs a full batch)
    for p in batch_buf:
        attr_time += _score_image(bundle, family, p, blur, result, args,
                                  maps)[1]

    total_time = time.time() - t0
    if maps is not None:
        maps.close()
    if shard:
        # the attribution seconds are summed too: the CSV's Attr Avg
        # Runtime is seconds of attribution work an image, over all
        # processes
        result, attr_time = multi_host.allreduce_sums(result, attr_time)
    # under --shard_images only process 0 writes: two processes writing
    # one path can tear it
    if images_used and (not shard or pidx == 0):
        folder = os.path.join(args.output_dir, args.model)
        write_result_csv(folder, f"{args.attr_func}_{args.image_count}_images",
                         result, images_used, attr_time, total_time)
    return {k: v / max(images_used, 1) for k, v in result.items()}


def build_parser():
    p = argparse.ArgumentParser("evaluate_perturbation")
    p.add_argument("--image_count", type=int, default=1000)
    p.add_argument("--model", type=str, default="R101",
                   help="R50, R101, R152, RNXT, VIT16, VIT32, CLIP16, "
                        "CLIP32, or another zoo name (swin_base, ...)")
    p.add_argument("--attr_func", type=str, default="ig")
    p.add_argument("--cuda_num", type=int, default=0,
                   help="CUDA device index")
    p.add_argument("--dataset_path", type=str, default="../../../ImageNet")
    p.add_argument("--class_maps_dir", type=str, default="")
    p.add_argument("--params_path", type=str, default="",
                   help="params saved by xai_tpu's save_params (.npz)")
    p.add_argument("--output_dir", type=str, default="pert_test_results")
    p.add_argument("--synthetic", type=int, default=0,
                   help="use N deterministic synthetic images (no dataset)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--verbose", action="store_true")
    p.add_argument("--profile_dir", type=str, default="",
                   help="write a torch.profiler Chrome trace of the run "
                        "here (through main)")
    p.add_argument("--image_batch", type=int, default=1,
                   help="attribute AND score N images per batch (one "
                        "batched attribution sweep and one batched "
                        "battery each)")
    p.add_argument("--attr_dtype", type=str, default="f32",
                   choices=["f32", "bf16"],
                   help="precision of the attribution sweep; bf16 runs "
                        "the forwards and backwards on a bf16 copy of the "
                        "model, with float32 Riemann accumulation")
    p.add_argument("--save_maps", action="store_true",
                   help="write every scored image's attribution map to "
                        "<output_dir>/<model>_<attr_func>_maps.h5 (needs "
                        "h5py)")
    p.add_argument("--skip_gates", action="store_true",
                   help="bypass the blur/black sanity gates (useful with "
                        "random weights; the reference gates assume a "
                        "trained model)")
    p.add_argument("--shard_images", action="store_true",
                   help="under a process group (parallel/multi_host.py): "
                        "stripe the kept images over processes and "
                        "allreduce the score sums, so that process 0 "
                        "writes the CSV of a single-process run")
    return p


def trace_path(args) -> str:
    """Where ``--profile_dir`` puts this process's Chrome trace."""
    return os.path.join(args.profile_dir, f"{args.model}_{args.attr_func}"
                        f"_p{multi_host.process_index()}.trace.json")


def main(argv=None, device=None):
    """The command line; ``device`` defaults to ``cuda:<--cuda_num>``.
    ``--profile_dir`` traces the whole run here, as xai_tpu's ``main``
    does; :func:`evaluate_perturbation` itself never traces."""
    args, _ = build_parser().parse_known_args(argv)
    if not args.profile_dir:
        scores = evaluate_perturbation(args, device)
    else:
        from torch.profiler import ProfilerActivity, profile

        device = resolve_device(device or f"cuda:{args.cuda_num}")
        acts = [ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        with profile(activities=acts) as prof:
            scores = evaluate_perturbation(args, device)
        os.makedirs(args.profile_dir, exist_ok=True)
        prof.export_chrome_trace(trace_path(args))
    print({k: round(v, 4) for k, v in scores.items()})


if __name__ == "__main__":
    main()
