"""Qualitative figure grids: all attribution methods for one image rendered
as a panel (XAI_Survey/evaluations/qualitativeGeneration.py — 16-panel CNN /
11-panel ViT / CLIP grids).

Counterpart of ``xai_tpu/runners/qualitative_generation.py`` with the same
flags and PNG layout.  :func:`panel_maps` does all the device work of one
image; :func:`write_grid` draws the grid with matplotlib, imported there
only.  As in xai_tpu, a method that fails leaves a "failed" panel and the
grid is still written; here the failed names are also returned.

Run: ``python -m xai_tpu_torch.runners.qualitative_generation --model R101
--synthetic 1`` (needs matplotlib).
"""
from __future__ import annotations

import argparse
import os

import numpy as np

from ..data.imagenet import ImageNetValStream
from ..registry import get_attribution
from .common import (attr_context, build_bundle, image_generator,
                     model_entry, normalize_input, predict_classes,
                     resolve_device)

# the reference's panel lists (qualitativeGeneration.py:104-231)
CNN_PANEL = ["grad", "inp_x_grad", "ig", "lig", "idg", "gig", "agi", "sg",
             "xrai", "gc", "gbp", "ggc", "gs", "lime", "fa", "occ"]
VIT_PANEL = ["attn", "grad", "n_rollout", "rollout", "t_attn", "bi_attn",
             "t_attr", "VIT_CX", "TIS", "InFlow", "MDA"]
CLIP_PANEL = ["eclip", "eclip_wo", "maskclip", "rollout", "selfattn",
              "game", "lrp", "surgery", "m2ib"]
PANELS = {"cnn": CNN_PANEL, "vit": VIT_PANEL, "clip": CLIP_PANEL}


def panel_maps(bundle, item, panel, seed: int, device):
    """Every ``panel`` method's ``[H, W]`` map of one stream ``item`` at
    the model's own top-1 class, each drawing from a fresh generator of
    ``(seed, item.index)``.  Returns ``(maps, failed)``: name -> map, and
    name -> "<error type>: <message>" for each method that raised."""
    family = bundle.meta.family
    x = normalize_input(item.trans_img, family, device)
    target = predict_classes(bundle, x[None])[0]
    maps, failed = {}, {}
    for name in panel:
        p = {"x": x, "trans_img": item.trans_img, "target": target,
             "generator": image_generator(seed, item.index, device)}
        try:
            maps[name] = get_attribution(family, name,
                                         attr_context(bundle, p))
        except Exception as e:  # xai_tpu's per-panel except (:70-72)
            failed[name] = f"{type(e).__name__}: {e}"
    return maps, failed


def write_grid(path: str, trans_img, panel, maps: dict) -> None:
    """The grid PNG: the input, then one panel a method, "failed" where
    ``maps`` has none."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from ..utils.visualization import attr_to_subplot

    n = len(panel) + 1
    cols = min(n, 6)
    rows = (n + cols - 1) // cols
    fig, axs = plt.subplots(rows, cols, figsize=(3 * cols, 3 * rows))
    axs = np.atleast_2d(axs)
    attr_to_subplot(trans_img, "input", axs[0, 0], original_image=True)
    for j, name in enumerate(panel, start=1):
        ax = axs[j // cols, j % cols]
        if name in maps:
            attr_to_subplot(maps[name][..., None], name, ax)
        else:
            ax.set_title(f"{name}: failed")
    for j in range(n, rows * cols):
        axs[j // cols, j % cols].axis("off")
    fig.tight_layout()
    fig.savefig(path, dpi=100)
    plt.close(fig)


def generate(args, device=None) -> dict:
    """Write one grid an image; returns {png path: failed names}.
    ``device`` defaults to ``cuda:<--cuda_num>``."""
    device = resolve_device(device or f"cuda:{args.cuda_num}")
    family, _ = model_entry(args.model)
    bundle = build_bundle(args.model, args.params_path, device=device)
    panel = args.methods.split(",") if args.methods else PANELS[family]

    stream = ImageNetValStream(args.dataset_path, img_hw=bundle.meta.img_hw,
                               synthetic=args.synthetic)
    os.makedirs(args.output_dir, exist_ok=True)
    written = {}
    for item in stream:
        if len(written) >= args.image_count:
            break
        maps, failed = panel_maps(bundle, item, panel, args.seed, device)
        for name, err in failed.items():
            print(f"{name} failed: {err}")
        out = os.path.join(args.output_dir, f"{args.model}_{item.name}.png")
        write_grid(out, item.trans_img, panel, maps)
        print(f"wrote {out}")
        written[out] = sorted(failed)
    return written


def build_parser():
    p = argparse.ArgumentParser("qualitative_generation")
    p.add_argument("--image_count", type=int, default=1)
    p.add_argument("--model", type=str, default="R101")
    p.add_argument("--methods", type=str, default="",
                   help="comma list; default = full family panel")
    p.add_argument("--cuda_num", type=int, default=0,
                   help="CUDA device index")
    p.add_argument("--dataset_path", type=str, default="../../../ImageNet")
    p.add_argument("--params_path", type=str, default="",
                   help="params saved by xai_tpu's save_params (.npz)")
    p.add_argument("--output_dir", type=str, default="qualitative_results")
    p.add_argument("--synthetic", type=int, default=0)
    p.add_argument("--seed", type=int, default=0)
    return p


def main(argv=None):
    args, _ = build_parser().parse_known_args(argv)
    generate(args)


if __name__ == "__main__":
    main()
