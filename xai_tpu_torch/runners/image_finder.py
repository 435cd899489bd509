"""Correctly-classified mask generator — the reference's
util/image_finder/findCorrectlyClassifiedImageNet.py: classify every
validation image in batches, write the 0/1 mask file that the evaluation
drivers use as their image filter.

Counterpart of ``xai_tpu/runners/image_finder.py`` with the same flags and
mask file.  The models of the drivers' table run here, CLIP16 and CLIP32
among them (classified by their class-prompt text table), and so does
every other name of the extended zoo (``models/__init__.py
EXTENDED_ZOO``: VGG, Inception-v3, ConvNeXt, Swin, PVT, MaxViT and the
timm ViTs), each at its own input size (IV3 streams 299 px crops) and
normalized as its family is.  ``--params_path`` reads the flat ``.npz``
of xai_tpu's ``save_params`` or of ``python -m xai_tpu_torch.convert.cli``
(xai_tpu's extended branch unpickles; the port never does).

Run: ``python -m xai_tpu_torch.runners.image_finder --model R101
--dataset_path <imagenet-val-dir> --ground_truth
ILSVRC2012_validation_ground_truth.txt``.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from ..data.classmaps import load_ground_truth, save_correct_mask
from ..data.imagenet import ImageNetValStream
from .common import (build_bundle, normalize_input, predict_classes,
                     resolve_device)


def find_correctly_classified(args, device=None) -> np.ndarray:
    """Write ``correctly_classified_<model>.txt``; returns the mask.
    ``device`` defaults to ``cuda:<--cuda_num>``."""
    device = resolve_device(device or f"cuda:{args.cuda_num}")
    bundle = build_bundle(args.model, args.params_path, device=device)
    family = bundle.meta.family
    gnd = load_ground_truth(args.ground_truth)
    n_total = args.total or len(gnd)
    mask = np.zeros(n_total, np.int64)

    # the bundle's own input resolution (IV3 299 px, the tiny CI models
    # 64)
    stream = ImageNetValStream(args.dataset_path, img_hw=bundle.meta.img_hw,
                               synthetic=args.synthetic)
    buf_x, buf_idx = [], []

    def flush():
        if not buf_x:
            return
        preds = predict_classes(bundle, torch.stack(buf_x))
        for idx, pred in zip(buf_idx, preds):
            if idx < n_total and pred == gnd[idx]:
                mask[idx] = 1
        buf_x.clear()
        buf_idx.clear()

    for item in stream:
        buf_x.append(normalize_input(item.trans_img, family, device))
        buf_idx.append(item.index)
        if len(buf_x) == args.batch_size:
            flush()
    flush()

    path = save_correct_mask(args.class_maps_dir, args.model, mask)
    print(f"wrote {path}: {mask.sum()}/{n_total} correctly classified")
    return mask


def build_parser():
    p = argparse.ArgumentParser("image_finder")
    p.add_argument("--model", type=str, default="R101")
    p.add_argument("--dataset_path", type=str, default="../../../ImageNet")
    p.add_argument("--ground_truth", type=str,
                   default="ILSVRC2012_validation_ground_truth.txt")
    p.add_argument("--class_maps_dir", type=str, default="class_maps")
    p.add_argument("--params_path", type=str, default="",
                   help="params saved by xai_tpu's save_params or by "
                   "xai_tpu_torch.convert.cli (.npz)")
    p.add_argument("--batch_size", type=int, default=100)
    p.add_argument("--total", type=int, default=0)
    p.add_argument("--synthetic", type=int, default=0)
    p.add_argument("--cuda_num", type=int, default=0,
                   help="CUDA device index")
    return p


def main(argv=None):
    args, _ = build_parser().parse_known_args(argv)
    find_correctly_classified(args)


if __name__ == "__main__":
    main()
