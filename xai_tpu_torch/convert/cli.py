"""Weight-conversion CLI: a torch checkpoint -> the flat ``.npz`` that
every driver's ``--params_path`` reads.

Takes the arch names of ``xai_tpu/convert/cli.py`` and writes the arrays
that xai_tpu's converter followed by its ``save_params`` would write for
the same checkpoint, so both packages' ``load_params`` read the file.

Usage:
    python -m xai_tpu_torch.convert.cli --arch swin_tiny \\
        --torch swin_tiny_hf.pth --out swin_tiny.npz
    python -m xai_tpu_torch.runners.image_finder --model swin_tiny \\
        --params_path swin_tiny.npz ...

The checkpoint is read with ``torch.load(..., weights_only=True)``.  A
file that holds more than tensors (a pickled module, say) needs the
unpickler, which runs code: it is refused unless ``--trust_pickle`` is
given.
"""
from __future__ import annotations

import argparse

import numpy as np

from .torch_import import ARCH_CONVERTERS, convert, flatten


def load_state_dict(path: str, trust_pickle: bool = False):
    """The state dict of a checkpoint file: the file itself, its
    ``state_dict`` entry, or a module's ``state_dict()``."""
    import pickle

    import torch

    try:
        obj = torch.load(path, map_location="cpu", weights_only=True)
    except pickle.UnpicklingError as e:
        if not trust_pickle:
            raise SystemExit(
                f"{path} holds more than tensors, so torch.load("
                "weights_only=True) refuses it; reading it runs the "
                "unpickler, which can run code.  Pass --trust_pickle if "
                f"the file is trusted.\n({e})")
        print(f"{path}: not loadable with weights_only=True; unpickling it "
              "(--trust_pickle)")
        obj = torch.load(path, map_location="cpu", weights_only=False)
    if hasattr(obj, "state_dict"):
        obj = obj.state_dict()
    if isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    return obj


def build_parser():
    p = argparse.ArgumentParser("convert")
    p.add_argument("--arch", required=True, choices=sorted(ARCH_CONVERTERS),
                   metavar="ARCH", help=", ".join(ARCH_CONVERTERS))
    p.add_argument("--torch", dest="torch_path", required=True)
    p.add_argument("--out", required=True, help="the .npz to write")
    p.add_argument("--trust_pickle", action="store_true",
                   help="unpickle a checkpoint that weights_only refuses")
    return p


def main(argv=None):
    args, _ = build_parser().parse_known_args(argv)
    if not args.out.endswith(".npz"):
        raise SystemExit(f"--out {args.out}: the port writes .npz only")
    sd = load_state_dict(args.torch_path, args.trust_pickle)
    flat = flatten(convert(args.arch, sd))
    np.savez(args.out, **flat)
    n = sum(v.size for v in flat.values())
    print(f"wrote {args.out} ({n / 1e6:.1f}M params)")


if __name__ == "__main__":
    main()
