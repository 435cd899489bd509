"""Float32 parity of the port's batched attribution, card against CPU.

For TINY_R inputs at 64 and 32 px (zero biases as ``init_random`` makes
them, or seeded random biases), runs ``batch_attribution`` (ig, lig, idg,
idgi, grad, inp_x_grad) and ``sg_batch`` with injected noise, B=3, on the
GPU and on the CPU, in float32 and float64, plus the GPU in TF32 and in
bf16 as controls.  Prints one JSON line per input set: the max relative
error of each method for each pair.  A pair that differs in float32 far
beyond its float64 gap has met a ReLU input within rounding of zero.

Run from the repo root on a machine with a CUDA GPU:
``python3 tools/torch_float32_parity_probe.py``.
"""
import json
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from xai_tpu_torch.methods.batch import (  # noqa: E402
    batch_attribution, sg_batch)
from xai_tpu_torch.runners.common import (  # noqa: E402
    build_bundle, normalize_input, resolve_device)

METHODS = ("ig", "lig", "idg", "idgi", "grad", "inp_x_grad", "sg")
# (image seed, bias seed, bias scale, px); scale 0 keeps init_random's
# zero biases, as chip_smoke.py's TINY_R has them
CONFIGS = ((9, 0, 0.0, 64), (1, 0, 0.0, 64), (2, 0, 0.0, 64),
           (3, 0, 0.0, 64), (9, 5, 0.1, 64), (9, 5, 0.5, 64),
           (9, 0, 0.0, 32), (1, 0, 0.0, 32))


def bundle_for(bias_seed, scale, device):
    b = build_bundle("TINY_R", seed=1, device="cpu")
    if scale:
        gen = torch.Generator().manual_seed(bias_seed)
        with torch.no_grad():
            for name, p in b.module.named_parameters():
                if name.endswith("bias"):
                    p.copy_(scale * torch.randn(p.shape, generator=gen))
    b.module.to(device)
    return b


def run(b, imgs, noises, device, dtype):
    xs = torch.stack([normalize_input(im, "cnn", device) for im in imgs])
    tg = b.apply(xs.permute(0, 3, 1, 2)).argmax(-1).tolist()
    out = {}
    for m in METHODS:
        if m == "sg":
            out[m] = sg_batch(b, xs, torch.tensor(tg, device=device),
                              noises=noises, dtype=dtype).float().cpu().numpy()
        else:
            out[m] = batch_attribution("cnn", m, b, xs, imgs, tg, None,
                                       img_hw=imgs.shape[1], dtype=dtype)
    return tg, out


def rel(a, b):
    return {m: float(np.abs(a[m] - b[m]).max() / np.abs(b[m]).max())
            for m in METHODS}


def set_tf32(on: bool) -> None:
    torch.backends.cudnn.allow_tf32 = on
    torch.backends.cuda.matmul.allow_tf32 = on


def main() -> None:
    dev = resolve_device("cuda")
    for img_seed, bias_seed, scale, hw in CONFIGS:
        t0 = time.time()
        imgs = np.random.RandomState(img_seed).rand(3, hw, hw, 3).astype(
            np.float32)
        noises = (0.5 * np.random.RandomState(12).randn(3, 4, hw, hw, 3)
                  ).astype(np.float32)
        bc = bundle_for(bias_seed, scale, "cpu")
        bg = bundle_for(bias_seed, scale, dev)
        tc, cpu32 = run(bc, imgs, noises, "cpu", None)
        _, cpu64 = run(bc, imgs, noises, "cpu", torch.float64)
        tgg, gpu32 = run(bg, imgs, noises, dev, None)
        _, gpu64 = run(bg, imgs, noises, dev, torch.float64)
        set_tf32(True)
        _, tf32 = run(bundle_for(bias_seed, scale, dev), imgs, noises, dev,
                      None)
        set_tf32(False)
        _, bf16 = run(bundle_for(bias_seed, scale, dev), imgs, noises, dev,
                      torch.bfloat16)
        print(json.dumps({
            "img_seed": img_seed, "bias_seed": bias_seed, "scale": scale,
            "hw": hw, "targets": [tc, tgg],
            "gpu32_cpu32": rel(gpu32, cpu32), "cpu32_cpu64": rel(cpu32, cpu64),
            "gpu32_gpu64": rel(gpu32, gpu64), "gpu64_cpu64": rel(gpu64, cpu64),
            "tf32_cpu32": rel(tf32, cpu32), "bf16_cpu32": rel(bf16, cpu32),
            "s": time.time() - t0}), flush=True)


if __name__ == "__main__":
    main()
