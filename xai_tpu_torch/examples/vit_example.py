"""ViT walkthrough: raw attention, rollout, transition attention,
bidirectional attribution and InFlow on ViT-B/16, and MDA from the
bidirectional prior.

The counterpart of xai_tpu's ``examples/vit_example.py``.  Run:

    python -m xai_tpu_torch.examples.vit_example [--image f.jpg]
        [--params p.npz] [--with_mda] [--device cuda]
"""
from __future__ import annotations

import numpy as np
import torch

from ..methods import vit_explain as VE
from ..methods.mda import mda
from ..ops import make_blur_fn, resize_bilinear
from .common import bundle_and_input, parser

PATCH_COUNT = 196


def run(bundle, x, trans_img, with_mda: bool = False,
        patch_count: int = PATCH_COUNT) -> dict:
    """The five attention maps of the normalized ``[H, W, 3]`` input
    ``x`` for the model's top class, resized to the image, ``{name: |map|
    [H, W]}``; with ``with_mda``, MDA's map from the bidirectional prior
    too (``trans_img`` ``[H, W, 3]`` in [0, 1] gives its superpixels)."""
    xb = x[None]
    with torch.no_grad():
        target = int(bundle.apply(x.permute(2, 0, 1)[None])[0].argmax())
    print("target:", target)
    hw = (bundle.meta.img_hw, bundle.meta.img_hw)
    explainers = {
        "raw attn": lambda: VE.raw_attn(bundle, xb),
        "rollout": lambda: VE.rollout(bundle, xb),
        "t_attn": lambda: VE.transition_attention(bundle, xb, [target]),
        "bi_attn": lambda: VE.bidirectional(bundle, xb, [target]),
        "InFlow": lambda: VE.rave(bundle, xb, [target]),
    }
    resized, out = {}, {}
    for name, fn in explainers.items():
        resized[name] = resize_bilinear(fn()[0].float(), hw)
        out[name] = resized[name].abs().cpu().numpy()
        print(f"{name:8s} map sum={out[name].sum():.4f} "
              f"peak={out[name].max():.6f}")
    if with_mda:
        prior3 = np.repeat(resized["bi_attn"].cpu().numpy()[..., None], 3,
                           -1)
        out["MDA"] = mda(bundle, trans_img, x, prior3, patch_count,
                         make_blur_fn(), target=target)
        print("MDA map sum:", float(np.abs(out["MDA"]).sum()))
    return out


def main(argv=None) -> dict:
    p = parser("attention explainers and MDA of ViT-B/16")
    p.add_argument("--with_mda", action="store_true")
    args = p.parse_args(argv)
    bundle, trans_img, x = bundle_and_input(args, "VIT16")
    return run(bundle, x, trans_img, args.with_mda)


if __name__ == "__main__":
    main()
