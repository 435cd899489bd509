"""Segmentation driver: attribution as binary segmentation vs ground-truth
masks -> pixAcc / mIoU / mAP / mF1 -> TXT.

Counterpart of ``xai_tpu/runners/evaluate_imagenet_seg.py`` with the same
flags and TXT layout (the reference's
XAI_Survey/evaluations/evaluateImageNetSeg.py): per (image, mask):
attribution -> minmax normalize -> threshold at the mean -> binary
channels -> accumulate (:470-573).  Image i draws from
``image_generator(--seed, i)``.

xai_tpu's per-image path builds its registry context without the
attribution dtype, so ``--attr_dtype bf16`` acts only under
``--image_batch``; the port keeps that.

Run: ``python -m xai_tpu_torch.runners.evaluate_imagenet_seg --model R101
--attr_func ig --synthetic 2`` (``--dataset_path gtsegs_ijcv.mat`` for the
real set, which needs h5py and PIL).
"""
from __future__ import annotations

import argparse
import os

import numpy as np

from ..data.segmentation import ImagenetSegmentation
from ..metrics.seg import best_threshold, eval_batch
from ..registry import get_attribution
from .common import (ATTR_DTYPES, attr_context, batch_attribute,
                     build_bundle, image_generator, model_entry,
                     normalize_input, predict_classes, reject_unported,
                     resolve_device)


class SegTotals:
    """The seg drivers' accumulators: int64 pixel counts, per-image AP and
    F1.  ``best``: each image at its best-IoU threshold
    (evaluateImageNetSeg.py:331-360); else at ``thr``, or at the map's
    mean where ``thr`` is None."""

    def __init__(self, best: bool, thr=None):
        self.best = best
        self.thr = thr
        self.inter = np.zeros(2, np.int64)
        self.union = np.zeros(2, np.int64)
        self.correct = np.int64(0)
        self.label = np.int64(0)
        self.ap, self.f1 = [], []

    def add(self, sal, gt_mask) -> None:
        if self.best:
            sal, thr = best_threshold(sal, gt_mask)
            correct, labeled, inter, union, ap, f1 = eval_batch(
                sal, gt_mask, thr=thr, normalized=True)
        else:
            correct, labeled, inter, union, ap, f1 = eval_batch(
                sal, gt_mask, thr=self.thr)
        self.correct += np.int64(correct)
        self.label += np.int64(labeled)
        self.inter += inter.astype(np.int64)
        self.union += union.astype(np.int64)
        self.ap.append(ap)
        self.f1.append(f1)

    def scores(self) -> dict:
        return {
            "pixAcc": float(self.correct / (np.spacing(1) + self.label)),
            "mIoU": float((self.inter / (np.spacing(1) + self.union))
                          .mean()),
            "mAP": float(np.mean(self.ap)) if self.ap else 0.0,
            "mF1": float(np.mean(self.f1)) if self.f1 else 0.0}

    def write(self, path: str) -> dict:
        """The driver's TXT at ``path``; returns the scores."""
        scores = self.scores()
        with open(path, "w") as fh:
            fh.write("Mean IoU over %d classes: %.4f\n" % (2, scores["mIoU"]))
            fh.write("Pixel-wise Accuracy: %2.2f%%\n"
                     % (scores["pixAcc"] * 100))
            fh.write("Mean AP over %d classes: %.4f\n" % (2, scores["mAP"]))
            fh.write("Mean F1 over %d classes: %.4f\n" % (2, scores["mF1"]))
        return scores


def _flush(bundle, family, buf, totals, args) -> None:
    """Batched attribution of a buffer (one batched call where the method
    has one, ``methods/batch.py``), then per-image scoring on the host."""
    sals, _ = batch_attribute(bundle, family, args.attr_func, buf,
                              ATTR_DTYPES[args.attr_dtype])
    for p, sal in zip(buf, sals):
        totals.add(np.asarray(sal), p["gt_mask"])
    buf.clear()


def evaluate_imagenet_seg(args, device=None) -> dict:
    """Run the driver; ``device`` defaults to ``cuda:<--cuda_num>``."""
    reject_unported([(args.shard_images, "--shard_images", "A14")])
    device = resolve_device(device or f"cuda:{args.cuda_num}")
    family, _ = model_entry(args.model)
    bundle = build_bundle(args.model, args.params_path, device=device)

    ds = ImagenetSegmentation(args.dataset_path, img_hw=bundle.meta.img_hw,
                              synthetic=args.synthetic)
    # MDA_dense: the best-IoU threshold instead of the mean
    totals = SegTotals(best=args.attr_func == "MDA_dense")
    buf = []
    for i, item in enumerate(ds):
        if args.image_count and i >= args.image_count:
            break
        x = normalize_input(item.trans_img, family, device)
        p = {"x": x, "trans_img": item.trans_img, "gt_mask": item.gt_mask,
             "target": predict_classes(bundle, x[None])[0],
             "generator": image_generator(args.seed, i, device)}
        if args.image_batch > 1:
            buf.append(p)
            if len(buf) == args.image_batch:
                _flush(bundle, family, buf, totals, args)
            continue
        # no dtype: xai_tpu's per-image context has none (see the module
        # docstring)
        sal = get_attribution(family, args.attr_func,
                              attr_context(bundle, p))
        totals.add(sal, item.gt_mask)
        if args.verbose:
            s = totals.scores()
            print(f"[{i + 1}] pixAcc {s['pixAcc']:.4f} mIoU "
                  f"{s['mIoU']:.4f}")
    if buf:
        _flush(bundle, family, buf, totals, args)

    folder = os.path.join(args.output_dir, args.model)
    os.makedirs(folder, exist_ok=True)
    return totals.write(os.path.join(
        folder, f"{args.attr_func}_{args.image_count}_images"))


def build_parser():
    p = argparse.ArgumentParser("evaluate_imagenet_seg")
    p.add_argument("--image_count", type=int, default=0,
                   help="0 = full dataset")
    p.add_argument("--model", type=str, default="R101")
    p.add_argument("--attr_func", type=str, default="ig")
    p.add_argument("--cuda_num", type=int, default=0,
                   help="CUDA device index")
    p.add_argument("--dataset_path", type=str,
                   default="gtsegs_ijcv.mat")
    p.add_argument("--params_path", type=str, default="",
                   help="params saved by xai_tpu's save_params (.npz)")
    p.add_argument("--output_dir", type=str, default="seg_test_results")
    p.add_argument("--synthetic", type=int, default=0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--verbose", action="store_true")
    p.add_argument("--attr_dtype", type=str, default="f32",
                   choices=("f32", "bf16"),
                   help="attribution sweep dtype, under --image_batch "
                        "only (as in xai_tpu)")
    p.add_argument("--image_batch", type=int, default=1,
                   help="batched attribution of N images (methods with a "
                        "batched implementation)")
    p.add_argument("--shard_images", action="store_true",
                   help="not ported yet (raises)")
    return p


def main(argv=None):
    args, _ = build_parser().parse_known_args(argv)
    print({k: round(v, 4) for k, v in evaluate_imagenet_seg(args).items()})


if __name__ == "__main__":
    main()
