"""The older ViT-focused segmentation driver
(XAI_Survey/evaluations/imagenet_seg_eval.py).

Counterpart of ``xai_tpu/runners/imagenet_seg_eval.py`` with the same
flags and TXT: the pixAcc / mIoU / mAP / mF1 accumulation of the seg
driver plus the research knobs: ``--method`` covering the registry's
explainers, ``shap`` (Shapley value sampling over the 14 x 14 patch
grid, ``--shap_samples`` permutations), the MDA variants and
``Calibrate_Best_Possible`` (the MASCalibrator upper bound, :172-194:
slic segments and ``refine_attribution`` of rollout), with ``--thr`` and
``--acc_cutoff``.  ``Calibrate_Best_Possible`` and ``MDA_dense`` take
each image's best-IoU threshold.  Image i draws from
``image_generator(--seed, i)``.  ``--shard_images`` stripes the dataset
index over the processes of a process group, as the seg driver does
(the ``--acc_cutoff`` skip comes after the stripe), and gathers the
accumulators and the skip count exactly; only process 0 writes.

Run: ``python -m xai_tpu_torch.runners.imagenet_seg_eval --model VIT16
--method rollout --synthetic 2`` (``--dataset_path gtsegs_ijcv.mat`` for
the real set, which needs h5py and PIL).
"""
from __future__ import annotations

import argparse

import numpy as np

from ..data.segmentation import ImagenetSegmentation
from ..parallel import multi_host
from ..registry import get_attribution
from .common import (ATTR_DTYPES, attr_context, batch_attribute,
                     build_bundle, image_generator, model_entry,
                     normalize_input, resolve_device)
from .evaluate_imagenet_seg import SegTotals

# the methods that go image by image whatever --image_batch says
UNBATCHED = ("shap", "Calibrate_Best_Possible")


def _patch_count(bundle) -> int:
    # a CNN's meta has no patch grid; the reference driver's grid is a
    # fixed 14 x 14 there (imagenet_seg_eval.py:330 segment_count)
    return (bundle.meta.num_patches or 14) ** 2


def _get_attr(args, bundle, family, ctx) -> np.ndarray:
    if args.method == "shap":
        from ..methods.ablation import shapley_sampling
        from ..methods.gradient import to_saliency
        return to_saliency(shapley_sampling(
            ctx.bundle, ctx.x, ctx.target, ctx.generator,
            n_samples=args.shap_samples))
    if args.method == "Calibrate_Best_Possible":
        from ..methods.mas_calibrate import refine_attribution
        from ..native import slic
        seg = slic(np.asarray(ctx.trans_img, np.float32),
                   _patch_count(bundle), 10000.0)
        base = np.repeat(np.asarray(get_attribution(family, "rollout",
                                                    ctx))[..., None],
                         3, axis=-1)
        _, smoothed = refine_attribution(bundle, ctx.x, base,
                                         epochs=args.epochs, segments=seg)
        return np.abs(smoothed.sum(-1))
    return get_attribution(family, args.method, ctx)


def _flush(args, bundle, family, buf, totals, dtype) -> None:
    """A buffer of kept images: one batched attribution where the method
    has one (``methods/batch.py``), else image by image."""
    if args.method in UNBATCHED:
        sals = [_get_attr(args, bundle, family, attr_context(bundle, p,
                                                             dtype))
                for p in buf]
    else:
        sals, _ = batch_attribute(bundle, family, args.method, buf, dtype)
    for p, sal in zip(buf, sals):
        totals.add(np.asarray(sal), p["gt_mask"])
    buf.clear()


def run(args, device=None) -> dict:
    """Run the driver; ``device`` defaults to ``cuda:<--cuda_num>``."""
    device = resolve_device(device or f"cuda:{args.cuda_num}")
    family, _ = model_entry(args.model)
    bundle = build_bundle(args.model, args.params_path, device=device)
    ds = ImagenetSegmentation(args.dataset_path, img_hw=bundle.meta.img_hw,
                              synthetic=args.synthetic)
    dtype = ATTR_DTYPES[args.attr_dtype]
    # per-image best-IoU threshold (imagenet_seg_eval.py:194-222); else
    # --thr > 0 fixes the fg/bg split and 0 keeps the mean threshold
    totals = SegTotals(
        best=args.method in ("Calibrate_Best_Possible", "MDA_dense"),
        thr=args.thr if args.thr > 0 else None)
    buf = []
    shard = args.shard_images and multi_host.process_count() > 1
    pidx, pcount = multi_host.process_index(), multi_host.process_count()
    for i, item in enumerate(ds):
        if args.image_count and i >= args.image_count:
            break
        if shard and i % pcount != pidx:
            continue
        x = normalize_input(item.trans_img, family, device)
        probs = bundle.probs(x.permute(2, 0, 1)[None].contiguous())[0]
        target = int(probs.argmax())
        # low-confidence skip (imagenet_seg_eval.py:234: percent scale)
        if float(probs[target]) * 100 < args.acc_cutoff:
            totals.skipped += 1
            continue
        p = {"x": x, "trans_img": item.trans_img, "gt_mask": item.gt_mask,
             "target": target,
             "generator": image_generator(args.seed, i, device)}
        buf.append(p)
        if args.image_batch <= 1 or len(buf) == args.image_batch:
            _flush(args, bundle, family, buf, totals, dtype)
    if buf:
        _flush(args, bundle, family, buf, totals, dtype)

    if shard:
        totals.gather()
    if totals.skipped:
        print(f"skipped {totals.skipped} images below --acc_cutoff "
              f"{args.acc_cutoff}%")
    return totals.finish(shard, args.output_dir,
                         f"{args.model}_{args.method}.txt")


def build_parser():
    p = argparse.ArgumentParser("imagenet_seg_eval")
    p.add_argument("--method", type=str, default="rollout",
                   help="the registry's explainers + shap + "
                        "Calibrate_Best_Possible")
    p.add_argument("--model", type=str, default="VIT16")
    p.add_argument("--image_count", type=int, default=0)
    p.add_argument("--thr", type=float, default=0.0,
                   help="fixed fg/bg threshold; 0 = mean threshold")
    p.add_argument("--kappa", type=float, default=0.005)
    p.add_argument("--acc_cutoff", type=float, default=60.0,
                   help="skip images whose softmax confidence (percent) is "
                        "below this (imagenet_seg_eval.py:234; default 60)")
    p.add_argument("--epochs", type=int, default=25)
    p.add_argument("--shap_samples", type=int, default=25,
                   help="Shapley value sampling permutation count (captum "
                        "default 25, imagenet_seg_eval.py:165)")
    p.add_argument("--dataset_path", type=str, default="gtsegs_ijcv.mat")
    p.add_argument("--params_path", type=str, default="",
                   help="params saved by xai_tpu's save_params (.npz)")
    p.add_argument("--output_dir", type=str, default="seg_eval_results")
    p.add_argument("--synthetic", type=int, default=0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--cuda_num", type=int, default=0,
                   help="CUDA device index")
    p.add_argument("--attr_dtype", type=str, default="f32",
                   choices=("f32", "bf16"),
                   help="attribution sweep dtype (bf16 = opt-in fast path)")
    p.add_argument("--image_batch", type=int, default=1,
                   help="batched attribution of N images (methods with a "
                        "batched implementation)")
    p.add_argument("--shard_images", action="store_true",
                   help="under a process group (parallel/multi_host.py): "
                        "stripe images over processes and gather the "
                        "counters exactly; only process 0 writes the TXT")
    return p


def main(argv=None):
    args, _ = build_parser().parse_known_args(argv)
    print({k: round(v, 4) for k, v in run(args).items()})


if __name__ == "__main__":
    main()
