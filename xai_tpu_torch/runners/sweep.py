"""Sweep runner: the all{Pert,Sanity,Seg}Tests.txt batch equivalents with a
resumable manifest (per-run result streaming replaces the reference's
re-run-the-shell-line crash recovery).

Counterpart of ``xai_tpu/runners/sweep.py`` with the same tables, flags
and ``sweep_manifest.jsonl``.  Under a process group
(``parallel/multi_host.py initialize``) process r takes runs r, r + n,
r + 2n, ... of the n processes, into one shared output directory and
manifest, as xai_tpu does.  A run that fails is recorded with ``status:
error`` and the sweep goes on, as in xai_tpu.

Tables mirror XAI_Survey/evaluations/allPertTests.txt (84 rows),
allSanityTests.txt (72 rows) and allSegTests.txt (76 rows incl. duplicates;
encoded deduplicated here — VIT32 runs MDA_dense, VIT16 runs both MDA and
MDA_dense, matching the reference's command lines).
"""
from __future__ import annotations

import argparse
import json
import os
import time

from ..parallel import multi_host

_CNN = ["grad", "inp_x_grad", "ig", "lig", "idg", "gig", "agi", "sg",
        "xrai", "gc", "gbp", "ggc", "gs", "lime", "fa", "occ"]
_VIT = ["attn", "grad", "n_rollout", "rollout", "t_attn", "bi_attn",
        "t_attr", "VIT_CX", "TIS", "InFlow"]
_CLIP = ["eclip", "eclip_wo", "game", "maskclip", "rollout",
         "selfattn", "surgery", "m2ib", "lrp"]

# the reference's full paper sweep (allPertTests.txt:1-84 structure)
PERT_SWEEP = {
    "R101": _CNN,
    "RNXT": _CNN,
    "VIT16": _VIT + ["MDA"],
    "VIT32": _VIT + ["MDA"],
    "CLIP16": _CLIP,
    "CLIP32": _CLIP,
}

# allSanityTests.txt:1-72 — VIT32 swaps MDA for its dense variant
SANITY_SWEEP = {
    "R101": _CNN,
    "RNXT": _CNN,
    "VIT16": _VIT + ["MDA"],
    "VIT32": _VIT + ["MDA_dense"],
    "CLIP16": _CLIP,
    "CLIP32": _CLIP,
}

# allSegTests.txt:1-76 — VIT16 runs both MDA variants; duplicates collapsed
SEG_SWEEP = {
    "R101": _CNN,
    "RNXT": _CNN,
    "VIT16": _VIT + ["MDA", "MDA_dense"],
    "VIT32": _VIT + ["MDA_dense"],
    "CLIP16": _CLIP,
    "CLIP32": _CLIP,
}

SWEEPS = {"pert": PERT_SWEEP, "sanity": SANITY_SWEEP, "seg": SEG_SWEEP}


def _driver_entry(driver: str):
    """(build_parser, evaluate_fn) per driver."""
    if driver == "pert":
        from .evaluate_perturbation import build_parser, evaluate_perturbation
        return build_parser, evaluate_perturbation
    if driver == "sanity":
        from .evaluate_sanity import build_parser, evaluate_sanity
        return build_parser, evaluate_sanity
    if driver == "seg":
        from .evaluate_imagenet_seg import build_parser, evaluate_imagenet_seg
        return build_parser, evaluate_imagenet_seg
    raise ValueError(f"unknown driver {driver!r}; expected pert|sanity|seg")


def sweep_jobs(args) -> list:
    """The (driver, model, attr_func) runs the flags select, in order."""
    drivers = (list(SWEEPS) if args.drivers in ("", "all")
               else args.drivers.split(","))
    for d in drivers:
        if d not in SWEEPS:
            raise ValueError(f"unknown driver {d!r}; expected pert|sanity|seg")
    jobs = []
    for driver in drivers:
        table = SWEEPS[driver]
        models = args.models.split(",") if args.models else list(table)
        for model in models:
            if args.methods:
                attrs = args.methods.split(",")
            else:
                # CNN models not in the table reuse the R101 method list
                attrs = table.get(
                    model, table["R101"] if model.startswith("R") else [])
                if not attrs:
                    # a typo'd --models entry would otherwise produce zero
                    # jobs and a clean exit that looks like a finished sweep
                    raise ValueError(
                        f"model {model!r} has no method table for driver "
                        f"{driver!r} (known: {sorted(table)}); pass "
                        "--methods to sweep it anyway")
            for attr in attrs:
                jobs.append((driver, model, attr))
    return jobs


def _done(manifest_path: str) -> set:
    """The runs the manifest records as ok."""
    done = set()
    if os.path.exists(manifest_path):
        with open(manifest_path) as f:
            for line in f:
                rec = json.loads(line)
                if rec.get("status") == "ok":
                    # manifests without a "driver" field hold pert runs
                    done.add((rec.get("driver", "pert"),
                              rec["model"], rec["attr_func"]))
    return done


def run_sweep(args, device=None) -> list:
    """Run every selected run not yet in the manifest, appending one
    record a run; returns the records written.  ``device`` goes to each
    driver (default: its ``cuda:<--cuda_num>``).  Under a process group
    each process takes every n-th run, from its rank on."""
    jobs = multi_host.my_shard(sweep_jobs(args))
    manifest_path = os.path.join(args.output_dir, "sweep_manifest.jsonl")
    os.makedirs(args.output_dir, exist_ok=True)
    done = _done(manifest_path)
    records = []
    for driver, model, attr in jobs:
        if (driver, model, attr) in done:
            print(f"skip {driver}/{model}/{attr} (already in manifest)")
            continue
        print(f"=== {driver} {model} {attr} ===")
        build_parser, evaluate = _driver_entry(driver)
        t0 = time.time()
        argv = ["--model", model, "--attr_func", attr,
                "--image_count", str(args.image_count),
                "--synthetic", str(args.synthetic),
                "--output_dir", args.output_dir,
                "--attr_dtype", args.attr_dtype]
        if args.image_batch > 1:
            argv += ["--image_batch", str(args.image_batch)]
        if driver == "seg":
            if args.seg_dataset_path:
                argv += ["--dataset_path", args.seg_dataset_path]
        else:
            argv += ["--dataset_path", args.dataset_path,
                     "--class_maps_dir", args.class_maps_dir]
        sub = build_parser().parse_args(argv)
        try:
            scores = evaluate(sub, device=device)
            rec = {"driver": driver, "model": model, "attr_func": attr,
                   "status": "ok", "seconds": round(time.time() - t0, 2),
                   "scores": scores}
        except Exception as e:  # stream failures, keep sweeping
            rec = {"driver": driver, "model": model, "attr_func": attr,
                   "status": "error", "error": f"{type(e).__name__}: {e}"}
        with open(manifest_path, "a") as f:
            f.write(json.dumps(rec) + "\n")
        records.append(rec)
    return records


def build_parser():
    p = argparse.ArgumentParser("sweep")
    p.add_argument("--drivers", type=str, default="pert",
                   help="comma list of pert,sanity,seg — or 'all' for the "
                        "full paper sweep (up to 232 reference rows, "
                        "deduplicated to the 217 encoded here)")
    p.add_argument("--models", type=str, default="")
    p.add_argument("--methods", type=str, default="",
                   help="comma list overriding the per-model method table")
    p.add_argument("--image_count", type=int, default=1000)
    p.add_argument("--dataset_path", type=str, default="../../../ImageNet")
    p.add_argument("--seg_dataset_path", type=str, default="",
                   help="gtsegs_ijcv.mat path for the seg driver")
    p.add_argument("--class_maps_dir", type=str, default="")
    p.add_argument("--output_dir", type=str, default="pert_test_results")
    p.add_argument("--synthetic", type=int, default=0)
    p.add_argument("--image_batch", type=int, default=1,
                   help="fused attribution (+ battery, pert) batch size")
    p.add_argument("--attr_dtype", type=str, default="f32",
                   choices=["f32", "bf16"],
                   help="precision of the attribution sweeps")
    return p


def main(argv=None):
    args, _ = build_parser().parse_known_args(argv)
    run_sweep(args)


if __name__ == "__main__":
    main()
