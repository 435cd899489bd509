"""Sanity-check driver: attribution on trained vs weight-randomized model;
SSIM / Spearman / HOG-Spearman similarity -> CSV.

Counterpart of ``xai_tpu/runners/evaluate_sanity.py`` with the same flags
and CSV layout (the reference's XAI_Survey/evaluations/evaluateSanity.py).
The randomized model is the CNN family's re-initialization (:108-145:
kaiming-uniform on every conv weight, xavier-uniform on the dense weight,
nothing else); the attribution target comes from each model's own
prediction (:460-471).

The randomized weights are drawn on a CPU ``torch.Generator`` seeded from
``--seed + 1`` and then copied to the device, so the card and the CPU run
the same randomized model.  Both attributions of an image draw from a
generator of their own built from ``(--seed, image index)``, so a
stochastic method draws the same noise for both weight sets, as xai_tpu's
one key does.

Run: ``python -m xai_tpu_torch.runners.evaluate_sanity --model R101
--attr_func ig --synthetic 2 --image_count 2`` (add ``--image_batch 4
--attr_dtype bf16`` for the batched bf16 path).
"""
from __future__ import annotations

import argparse
import copy
import csv
import math
import os
import time

import torch

from ..data.classmaps import load_correct_mask
from ..data.imagenet import ImageNetValStream
from ..metrics.sanity import evaluate as sanity_evaluate
from ..models.common import ModelBundle
from ..registry import get_attribution
from .common import (ATTR_DTYPES, attr_context, batch_attribute,
                     build_bundle, image_generator, model_entry,
                     normalize_input, predict_classes, reject_unported,
                     resolve_device)

# the ROADMAP.md item that ports each family's randomization
_FAMILY_ITEM = {"vit": "A10", "clip": "A11"}


def randomize_family(bundle, family: str,
                     generator: torch.Generator) -> ModelBundle:
    """The family's weight randomization (evaluateSanity.py:108-145), on a
    copy of the bundle's module.  cnn: every 4-D (conv) weight gets a
    kaiming-uniform draw with bound sqrt(6 / fan_in), fan_in = in * kh *
    kw, and every 2-D (dense) weight a xavier-uniform draw with bound
    sqrt(6 / (in + out)); FoldedBN scales and biases and the dense bias
    stay.  These weights are the images of xai_tpu's ``kernel`` leaves
    under ``convert/from_jax.py``.  Draws come from ``generator`` in the
    module's parameter order and are copied to the module's device."""
    if family != "cnn":
        raise NotImplementedError(
            f"{family} weight randomization is not ported yet (ROADMAP.md "
            f"item {_FAMILY_ITEM.get(family, '?')})")
    module = copy.deepcopy(bundle.module)
    with torch.no_grad():
        for name, w in module.named_parameters():
            if not name.endswith(".weight") or w.dim() not in (2, 4):
                continue
            if w.dim() == 4:
                bound = math.sqrt(6.0 / (w.shape[1] * w.shape[2]
                                         * w.shape[3]))
            else:
                bound = math.sqrt(6.0 / (w.shape[0] + w.shape[1]))
            u = torch.rand(w.shape, generator=generator,
                           device=generator.device)
            w.copy_(u * (2 * bound) - bound)
    return ModelBundle(bundle.meta, module)


def _pending(p, target, args, device):
    """One weight set's pending entry for kept image ``p``, with a fresh
    generator of its own."""
    return dict(p, target=target,
                generator=image_generator(args.seed, p["index"], device))


def _score(attr, attr_r, totals) -> tuple:
    scores = sanity_evaluate(attr, attr_r)
    for k, v in zip(totals, scores):
        totals[k] += v
    return scores


def _flush_sanity(bundle, rand_bundle, family, buf, args, totals, device):
    """Batched flush: targets from 2 stacked forwards, attributions from
    one batched call a weight set, then the host SSIM/Spearman/HOG pairs
    (evaluateSanity.py:460-501 order)."""
    xs = torch.stack([p["x"] for p in buf])
    dtype = ATTR_DTYPES[args.attr_dtype]
    pend = [_pending(p, t, args, device)
            for p, t in zip(buf, predict_classes(bundle, xs))]
    pend_r = [_pending(p, t, args, device)
              for p, t in zip(buf, predict_classes(rand_bundle, xs))]
    sals, _ = batch_attribute(bundle, family, args.attr_func, pend, dtype)
    sals_r, _ = batch_attribute(rand_bundle, family, args.attr_func, pend_r,
                                dtype)
    for a, ar in zip(sals, sals_r):
        _score(a, ar, totals)
    buf.clear()


def evaluate_sanity(args, device=None) -> dict:
    """Run the driver; ``device`` defaults to ``cuda:<--cuda_num>``."""
    reject_unported([(args.shard_images, "--shard_images", "A14")])
    device = resolve_device(device or f"cuda:{args.cuda_num}")
    family, _ = model_entry(args.model)
    bundle = build_bundle(args.model, args.params_path, device=device)
    rand_bundle = randomize_family(
        bundle, family, torch.Generator().manual_seed(args.seed + 1))

    correct = load_correct_mask(args.class_maps_dir, args.model) \
        if args.class_maps_dir else None
    stream = ImageNetValStream(args.dataset_path, img_hw=bundle.meta.img_hw,
                               synthetic=args.synthetic)
    dtype = ATTR_DTYPES[args.attr_dtype]

    totals = {"SSIM": 0.0, "SPR": 0.0, "HOG": 0.0}
    images_used = 0
    buf = []
    t0 = time.time()
    for item in stream:
        if images_used == args.image_count:
            break
        if correct is not None and correct[item.index] == 0:
            continue
        p = {"x": normalize_input(item.trans_img, family, device),
             "trans_img": item.trans_img, "index": item.index}
        images_used += 1
        if args.image_batch > 1:
            buf.append(p)
            if len(buf) == args.image_batch:
                _flush_sanity(bundle, rand_bundle, family, buf, args, totals,
                              device)
            continue

        xs = p["x"][None]
        attr = get_attribution(family, args.attr_func, attr_context(
            bundle, _pending(p, predict_classes(bundle, xs)[0], args,
                             device), dtype))
        attr_r = get_attribution(family, args.attr_func, attr_context(
            rand_bundle, _pending(p, predict_classes(rand_bundle, xs)[0],
                                  args, device), dtype))
        ssim_v, spr_v, hog_v = _score(attr, attr_r, totals)
        if args.verbose:
            print(f"[{images_used}] SSIM={ssim_v:.4f} SPR={spr_v:.4f} "
                  f"HOG={hog_v:.4f}")
    if buf:
        _flush_sanity(bundle, rand_bundle, family, buf, args, totals, device)

    total_time = time.time() - t0
    if images_used:
        folder = os.path.join(args.output_dir, args.model)
        os.makedirs(folder, exist_ok=True)
        fn = os.path.join(folder,
                          f"{args.attr_func}_{args.image_count}_images.csv")
        with open(fn, "w") as f:
            w = csv.writer(f)
            for k in totals:
                w.writerow([k, str(totals[k] / images_used)])
            w.writerow(["Total Runtime", str(total_time)])
    return {k: v / max(images_used, 1) for k, v in totals.items()}


def build_parser():
    p = argparse.ArgumentParser("evaluate_sanity")
    p.add_argument("--image_count", type=int, default=1000)
    p.add_argument("--model", type=str, default="R101")
    p.add_argument("--attr_func", type=str, default="ig")
    p.add_argument("--cuda_num", type=int, default=0,
                   help="CUDA device index")
    p.add_argument("--dataset_path", type=str, default="../../../ImageNet")
    p.add_argument("--class_maps_dir", type=str, default="")
    p.add_argument("--params_path", type=str, default="",
                   help="params saved by xai_tpu's save_params (.npz)")
    p.add_argument("--output_dir", type=str, default="sanity_test_results")
    p.add_argument("--synthetic", type=int, default=0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--verbose", action="store_true")
    p.add_argument("--image_batch", type=int, default=1,
                   help="batched attribution of N images (both weight "
                        "sets); 1 = per-image")
    p.add_argument("--attr_dtype", type=str, default="f32",
                   choices=("f32", "bf16"),
                   help="attribution sweep dtype (bf16 runs the sweeps on "
                        "a bf16 copy of each model)")
    p.add_argument("--shard_images", action="store_true",
                   help="not ported yet (raises)")
    return p


def main(argv=None):
    args, _ = build_parser().parse_known_args(argv)
    print({k: round(v, 4) for k, v in evaluate_sanity(args).items()})


if __name__ == "__main__":
    main()
