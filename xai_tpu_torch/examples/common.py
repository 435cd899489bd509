"""What the three walkthroughs share: their common flags, the bundle and
the input."""
from __future__ import annotations

import argparse

import numpy as np
import torch

from ..ops import load_and_preprocess, normalize
from ..runners.common import build_bundle, family_stats, model_entry, \
    resolve_device


def parser(description: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--image", default="",
                   help="an image file; seeded noise without it")
    p.add_argument("--params", default="",
                   help="weights: the .npz of xai_tpu's save_params; "
                        "seeded random without it")
    p.add_argument("--device", default="cuda")
    return p


def bundle_and_input(args, model: str):
    """(bundle of the CLI name ``model``, trans_img ``[H, W, 3]`` numpy in
    [0, 1], the normalized input ``[H, W, 3]`` on the bundle's device) of
    the parsed flags.  An image the reference would skip (not three
    channels after the resize and crop) ends the run."""
    device = resolve_device(args.device)
    bundle = build_bundle(model, args.params or None, device=device)
    hw = bundle.meta.img_hw
    mean, std = family_stats(model_entry(model)[0])
    if not args.image:
        trans_img = np.random.RandomState(0).rand(hw, hw, 3).astype(
            np.float32)
        return bundle, trans_img, normalize(
            torch.as_tensor(trans_img, device=device), mean, std)
    loaded = load_and_preprocess(args.image, hw, mean, std, device)
    if loaded is None:
        raise SystemExit(f"{args.image}: not a 3-channel image after the "
                         "resize and crop; the reference skips it")
    trans_img, x = loaded
    return bundle, trans_img, x[0]
