"""The --image_batch driver on every card of a host against one card, and
the cost of a mesh's replicas.

For each ``--image_batch N`` of ``--batches``: ``evaluate_perturbation
--model M --attr_func ig --image_batch N --synthetic K`` once to warm up,
then with ``battery_mesh`` held to the driver's card (one card), held to
every visible card, the driver's first (what ``battery_mesh`` gives in
one process when the batch has two images a card), again every card,
again one card.  Each run's wall seconds (bundle build included) and the
CSV's ``Total Runtime`` (the image loop) are printed, with the largest
score difference between the two meshes.  Then the
seconds to copy the bundle to each other card (``ModelBundle.to``, what a
flush would pay if the bundle did not keep its replicas) for R101 and
VIT16.  Prints the card line and one JSON line.

Run from the repo root on a host with one or more CUDA cards:
``python3 tools/mesh_scaling_probe.py [--batches 4,8] [--images 16]``.
"""
import argparse
import csv
import json
import os
import subprocess
import sys
import tempfile
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from xai_tpu_torch.parallel.mesh import make_mesh  # noqa: E402
from xai_tpu_torch.runners import evaluate_perturbation as ep  # noqa: E402
from xai_tpu_torch.runners.common import (  # noqa: E402
    build_bundle, resolve_device)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def read_csv(path: str) -> dict:
    with open(path) as f:
        return {r[0]: float(r[1]) for r in csv.reader(f) if r}


def drive(model: str, batch: int, images: int, device, out_dir: str,
          one_card: bool) -> tuple:
    """(wall seconds, the CSV's rows) of one driver run."""
    flags = ["--model", model, "--attr_func", "ig", "--image_batch",
             str(batch), "--synthetic", str(images), "--image_count",
             str(1000 * images), "--output_dir", out_dir]
    cards = [device] + [torch.device("cuda", i)
                        for i in range(torch.cuda.device_count())
                        if i != device.index]
    real = ep.battery_mesh
    ep.battery_mesh = lambda d, b: make_mesh(
        devices=cards[:1] if one_card else cards)
    try:
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        ep.evaluate_perturbation(ep.build_parser().parse_args(flags),
                                 device=device)
        for i in range(torch.cuda.device_count()):
            torch.cuda.synchronize(i)
        wall = time.perf_counter() - t0
    finally:
        ep.battery_mesh = real
    return wall, read_csv(os.path.join(out_dir, model,
                                       f"ig_{1000 * images}_images.csv"))


def replica_seconds(name: str, device) -> list:
    """Seconds to copy ``name``'s bundle to each other card."""
    bundle = build_bundle(name, device=device)
    out = []
    for i in range(torch.cuda.device_count()):
        d = torch.device("cuda", i)
        if d == device:
            continue
        torch.cuda.synchronize(d)
        t0 = time.perf_counter()
        bundle._copy_to(d)
        torch.cuda.synchronize(d)
        out.append(time.perf_counter() - t0)
    return out


def main() -> None:
    p = argparse.ArgumentParser("mesh_scaling_probe")
    p.add_argument("--model", default="R101")
    p.add_argument("--batches", default="4,8")
    p.add_argument("--images", type=int, default=16)
    args = p.parse_args()
    card = card_line()
    print(card)
    device = resolve_device("cuda:0")
    report = {"card": card, "cards": torch.cuda.device_count(),
              "model": args.model, "images": args.images, "runs": {}}
    with tempfile.TemporaryDirectory() as tmp:
        for batch in map(int, args.batches.split(",")):
            drive(args.model, batch, args.images, device,
                  os.path.join(tmp, "warm"), True)
            runs = []
            for i, one in enumerate((True, False, False, True)):
                wall, rows = drive(args.model, batch, args.images, device,
                                   os.path.join(tmp, f"b{batch}_{i}"), one)
                runs.append({"mesh": "one card" if one else "every card",
                             "wall_s": wall,
                             "loop_s": rows.pop("Total Runtime"),
                             "attr_s_per_image": rows.pop(
                                 "Attr Avg Runtime"), "scores": rows})
                print(f"--image_batch {batch}, {runs[-1]['mesh']}: "
                      f"{wall:.3f} s wall, {runs[-1]['loop_s']:.3f} s the "
                      f"image loop on {card}", flush=True)
            diff = max(abs(runs[0]["scores"][k] - runs[1]["scores"][k])
                       for k in runs[0]["scores"])
            for r in runs:
                del r["scores"]
            report["runs"][batch] = {"runs": runs, "max_score_diff": diff}
    report["replica_s"] = {name: replica_seconds(name, device)
                           for name in ("R101", "VIT16")}
    print(card)
    print(json.dumps(report))


if __name__ == "__main__":
    main()
