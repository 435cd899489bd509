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

``--shard_images`` under a process group (``parallel/multi_host.py
initialize``): process r takes the images whose dataset index is r
modulo the process count, the int64 counters and the AP / F1 lists meet
exactly in ``allgather_obj`` (lists joined in rank order), and only
process 0 writes the TXT.  Every process returns the global scores.

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
from ..parallel import multi_host
from ..registry import get_attribution
from .common import (ATTR_DTYPES, attr_context, batch_attribute,
                     build_bundle, image_generator, model_entry,
                     normalize_input, predict_classes, resolve_device)


class SegTotals:
    """The seg drivers' accumulators: int64 pixel counts, per-image AP and
    F1, and the images a driver skipped.  ``best``: each image at its
    best-IoU threshold (evaluateImageNetSeg.py:331-360); else at ``thr``,
    or at the map's mean where ``thr`` is None."""

    def __init__(self, best: bool, thr=None):
        self.best = best
        self.thr = thr
        self.inter = np.zeros(2, np.int64)
        self.union = np.zeros(2, np.int64)
        self.correct = np.int64(0)
        self.label = np.int64(0)
        self.ap, self.f1 = [], []
        self.skipped = 0

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

    def gather(self) -> None:
        """Every process's accumulators, under a process group: the
        counters summed exactly and the AP / F1 lists joined in rank
        order (``multi_host.allgather_obj``)."""
        parts = multi_host.allgather_obj({
            "inter": self.inter, "union": self.union,
            "correct": int(self.correct), "label": int(self.label),
            "ap": self.ap, "f1": self.f1, "skipped": self.skipped})
        self.inter = np.sum([p["inter"] for p in parts],
                            axis=0).astype(np.int64)
        self.union = np.sum([p["union"] for p in parts],
                            axis=0).astype(np.int64)
        self.correct = np.int64(sum(p["correct"] for p in parts))
        self.label = np.int64(sum(p["label"] for p in parts))
        self.ap = [v for p in parts for v in p["ap"]]
        self.f1 = [v for p in parts for v in p["f1"]]
        self.skipped = sum(p["skipped"] for p in parts)

    def finish(self, shard: bool, folder: str, name: str) -> dict:
        """Write the TXT ``folder/name`` (under ``shard``, on process 0
        only); returns the scores."""
        if not shard or multi_host.process_index() == 0:
            os.makedirs(folder, exist_ok=True)
            return self.write(os.path.join(folder, name))
        return self.scores()

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
    device = resolve_device(device or f"cuda:{args.cuda_num}")
    family, _ = model_entry(args.model)
    bundle = build_bundle(args.model, args.params_path, device=device)

    ds = ImagenetSegmentation(args.dataset_path, img_hw=bundle.meta.img_hw,
                              synthetic=args.synthetic)
    # MDA_dense: the best-IoU threshold instead of the mean
    totals = SegTotals(best=args.attr_func == "MDA_dense")
    buf = []
    shard = args.shard_images and multi_host.process_count() > 1
    pidx, pcount = multi_host.process_index(), multi_host.process_count()
    for i, item in enumerate(ds):
        if args.image_count and i >= args.image_count:
            break
        if shard and i % pcount != pidx:
            continue
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

    if shard:
        totals.gather()
    return totals.finish(shard, os.path.join(args.output_dir, args.model),
                         f"{args.attr_func}_{args.image_count}_images")


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
                   help="under a process group (parallel/multi_host.py): "
                        "stripe the dataset over processes and gather the "
                        "pixAcc / IoU / AP / F1 accumulators exactly, so "
                        "that process 0 writes the TXT of a "
                        "single-process run")
    return p


def main(argv=None):
    args, _ = build_parser().parse_known_args(argv)
    print({k: round(v, 4) for k, v in evaluate_imagenet_seg(args).items()})


if __name__ == "__main__":
    main()
