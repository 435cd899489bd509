#!/usr/bin/env python3
"""The readings a cell's limits are set from, in one process: the
compared numbers of sound runs of the program on many seeds (the lower
readings), and of the lower-precision control put in the program's place
(the upper readings).  The benchmark's own runs never run the control.

    python3 portbench/calibrate.py --workload r101_ig_b4 \
        --seeds 1,2,3 --control-seeds 4,5,6 [--steps N] [--out f.jsonl]

For each ``--seeds`` seed: a fresh set-up of the program with that
seed's weights and images, ``--steps`` window steps (default: the steps
a run compares), and the run's check.  For each ``--control-seeds``
seed: the reference with TF32 on (the nearest precision below the
configurations' float32 with TF32 off) on as many pool images as a run
compares, judged by the same numbers.  A program reading lists the
non-finite outputs of its steps' images (``nonfinite``, which fails a
run).  Each reading also gives
``e2e_score_gap``, which no run compares: the largest gap between the
side's scores and the reference's scores of the reference's own map, so
that map error's effect on the scores shows.  One JSON line a reading on
standard output (and in ``--out``), then the least and the largest of
each number by side.  Needs the cell's CUDA cards for ``--seeds``, one
for the control.
"""
from __future__ import annotations

import argparse
import importlib
import json
import os
import sys
import time


def e2e_score_gap(sides: list, refs: list) -> float:
    """The largest gap of a side's scores from the reference's scores of
    its own map, over the images."""
    from portbench import compare
    return compare.numbers(sides, [dict(r, scores=r["own_scores"])
                                   for r in refs])["score_gap"]


def main(argv=None) -> int:
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from portbench import harness

    p = argparse.ArgumentParser("calibrate")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--steps", type=int, default=0)
    p.add_argument("--out", default="")
    args = p.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    control = [int(s) for s in args.control_seeds.split(",") if s]
    spec = harness.load_cell(args.workload)
    cards = spec["cell"]["chips"] if seeds else 1
    harness.pin_cards(cards)
    import numpy as np
    import torch

    from portbench import compare, trace
    from portbench.images import image_pool
    from portbench.weights import stream_seed

    cfg, traffic = spec["cfg"], spec["traffic"]
    entry = importlib.import_module(f"portbench.entries.{traffic['entry']}")
    if torch.cuda.device_count() != cards:
        print(f"calibrate: needs {cards} CUDA card(s)", file=sys.stderr)
        return 2
    print(f"card: {harness.card_line()}", file=sys.stderr)
    devices = [torch.device("cuda", i) for i in range(cards)]
    readings = []

    def emit(rec):
        readings.append(rec)
        print(json.dumps(rec), flush=True)

    for seed in seeds:
        t = time.perf_counter()
        cell = entry.Cell(cfg, traffic, seed, devices, trace.Spans())
        cell.setup()
        for _ in range(args.steps or traffic["check_steps"]):
            cell.step()
        sides = cell.checked()
        bad = harness.nonfinite(r for step in cell.records for r in step)
        cell.free()
        refs = entry.reference_records(cfg, traffic, seed, devices[0],
                                       cell.pool, sides, own_map=True)
        emit({"side": "program", "seed": seed, "images": len(sides),
              "nonfinite": [sorted(b) for b in bad],
              **compare.numbers(sides, refs),
              "e2e_score_gap": e2e_score_gap(sides, refs),
              "gaps": compare.score_gaps(sides, refs),
              "seconds": time.perf_counter() - t})
        del cell
    n = traffic["check_steps"] * traffic.get("check_per_step",
                                             traffic["image_batch"])
    for seed in control:
        t = time.perf_counter()
        pool = image_pool(traffic["images"], cfg["img_hw"], seed)
        rng = np.random.default_rng(stream_seed(seed, 2))
        picks = [int(i) for i in rng.choice(len(pool), n, replace=False)]
        sides = entry.control_records(cfg, traffic, seed, devices[0], pool,
                                      picks)
        refs = entry.reference_records(cfg, traffic, seed, devices[0], pool,
                                       sides, own_map=True)
        emit({"side": "control", "seed": seed, "images": n,
              **compare.numbers(sides, refs),
              "e2e_score_gap": e2e_score_gap(sides, refs),
              "gaps": compare.score_gaps(sides, refs),
              "seconds": time.perf_counter() - t})
    summary = {f"{side} {agg.__name__}": {
        k: agg(r[k] for r in readings if r["side"] == side)
        for k in (*compare.NAMES, "e2e_score_gap")}
        for side in ("program", "control") for agg in (min, max)
        if any(r["side"] == side for r in readings)}
    print(json.dumps({"workload": args.workload, **summary}))
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "a") as f:
            for r in readings:
                f.write(json.dumps({"workload": args.workload, **r}) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
