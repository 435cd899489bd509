"""CNN walkthrough: gradient, IG, LIG and IDG attributions of a ResNet,
scored with the perturbation battery and drawn as a panel.

The counterpart of xai_tpu's ``examples/cnn_example.py``.  Run:

    python -m xai_tpu_torch.examples.cnn_example [--image f.jpg]
        [--params p.npz] [--model R50] [--out cnn_example.png]
        [--device cuda]
"""
from __future__ import annotations

from ..methods import gradient as G
from ..metrics import run_battery
from ..ops import make_blur_fn
from .common import bundle_and_input, parser

STEPS = 50


def run(bundle, x, steps: int = STEPS) -> dict:
    """The four attributions of the normalized ``[H, W, 3]`` input ``x``
    for the model's top class, each reduced to a saliency and scored by
    the battery: ``{name: (saliency [H, W], scores)}``."""
    target, prob = bundle.predict(x.permute(2, 0, 1)[None])
    print(f"predicted class {target} (p={prob:.4f})")
    attrs = {
        "grad": lambda: G.grad(bundle, x, target),
        "ig": lambda: G.ig(bundle, x, target, steps=steps),
        "lig": lambda: G.ig(bundle, x, target, steps=steps, alpha_star=0.9),
        "idg": lambda: G.idg(bundle, x, target, steps=steps),
    }
    blur = make_blur_fn()
    out = {}
    for name, attr in attrs.items():
        sal = G.to_saliency(attr())
        scores = run_battery(bundle.apply, x, sal, blur)
        print(f"{name:5s} MAS_ins={scores['MAS_ins']:.4f} "
              f"MAS_del={scores['MAS_del']:.4f}")
        out[name] = (sal, scores)
    return out


def save_panel(trans_img, maps: dict, path: str) -> None:
    """The input beside each saliency, as a PNG, where matplotlib imports."""
    try:
        import matplotlib
    except ImportError:
        print(f"matplotlib does not import: the panel {path} was not "
              "written")
        return
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from ..utils.visualization import attr_to_subplot

    fig, axs = plt.subplots(1, len(maps) + 1, figsize=(15, 3))
    attr_to_subplot(trans_img, "input", axs[0], original_image=True)
    for ax, (name, sal) in zip(axs[1:], maps.items()):
        attr_to_subplot(sal[..., None], name, ax)
    fig.tight_layout()
    fig.savefig(path, dpi=100)
    plt.close(fig)
    print(f"wrote {path}")


def main(argv=None) -> dict:
    p = parser("gradient, IG, LIG and IDG of a ResNet, scored by the "
               "perturbation battery")
    p.add_argument("--model", default="R50")
    p.add_argument("--out", default="cnn_example.png")
    args = p.parse_args(argv)
    bundle, trans_img, x = bundle_and_input(args, args.model)
    out = run(bundle, x)
    save_panel(trans_img, {k: sal for k, (sal, _) in out.items()}, args.out)
    return out


if __name__ == "__main__":
    main()
