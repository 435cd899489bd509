"""One run of one cell of ``BENCHMARK.json``: set-up, the measured
window, the metrics, the check against the reference, the result line.

Everything that belongs to one cell is found by name: the cell's
configuration in ``configs/<config>.json``, its traffic mix in
``traffic/<traffic>.json`` (the entry that runs it, the method, the
batch, the precision, the image stream, the battery, how many steps the
check compares), the entry in ``entries/<entry>.py``, each
metric's reader in ``metrics/<metric>.py`` and the limits of the check in
``limits/<cell>.json``.  A new cell, configuration, mix or metric is new
files and new ``BENCHMARK.json`` entries; this file does not change.

The window is a closed loop: the next step starts when the last one has
returned, and the step running when ``--seconds`` expire finishes.  A
rate is the images completed over the seconds from the window's start
to the end of its last step.
"""
from __future__ import annotations

import argparse
import importlib
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

from . import compare, trace

HERE = Path(__file__).resolve().parent
REPO = HERE.parent
# top-level module names that no run may load: JAX, its libraries and the
# JAX package the program was ported from (compared as whole names: the
# program's own name begins with the last)
FORBIDDEN = ("jax", "jaxlib", "flax", "xai_tpu")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str, bench: dict = None) -> dict:
    """The cell ``name`` with its configuration, traffic mix and limits,
    each read from its own file."""
    bench = bench or load_json(REPO / "BENCHMARK.json")
    cells = {c["name"]: c for c in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; "
                       f"have {sorted(cells)}")
    cell = cells[name]
    cfgs = {c["name"]: c for c in bench["configs"]}
    return {"bench": bench, "cell": cell,
            "cfg": load_json(REPO / cfgs[cell["config"]]["file"]),
            "traffic": load_json(HERE / "traffic" / f"{cell['traffic']}.json"),
            "limits": load_json(HERE / "limits" / f"{name}.json")}


def metrics_of(bench: dict, cell: str, per_layer: bool) -> list:
    """The metric entries this cell reports, end-to-end or per-layer: an
    entry's ``workloads``, else every cell (a per-layer metric: every
    cell that reports the end-to-end metric it ``moves``)."""
    e2e = [m for m in bench["end_to_end"]
           if cell in m.get("workloads", [cell])]
    if not per_layer:
        return e2e
    moved = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (cell in m["workloads"] if "workloads" in m
                else m["moves"] in moved)]


def reader(name: str):
    """The reader of a metric: ``metrics/<name>.py``, by the name's part
    before its first dot, so that a quantity split by the end-to-end
    metric it moves (``device_idle_pct.mesh``) has one reader."""
    return importlib.import_module(
        f"portbench.metrics.{name.split('.')[0]}")


def nonfinite(records) -> list:
    """For each record whose map or scores are not all finite, the names
    of what is not (``map`` or the score's)."""
    out = []
    for r in records:
        names = {k for k, v in r["scores"].items() if not np.isfinite(v)}
        if not np.isfinite(r["map"]).all():
            names.add("map")
        if names:
            out.append(names)
    return out


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def pin_cards(chips: int, env=os.environ) -> None:
    """Leave the process only the cell's ``chips`` cards: the first
    ``chips`` of ``CUDA_VISIBLE_DEVICES``, or cards ``0..chips-1`` where it
    is unset.  Call it before CUDA starts.  The program's mesh takes every
    visible card (``battery_mesh``), so on a host of more cards a cell
    would otherwise spread over cards its device metrics do not read."""
    listed = env.get("CUDA_VISIBLE_DEVICES")
    ids = ([i for i in listed.split(",") if i.strip()] if listed is not None
           else [str(i) for i in range(chips)])
    env["CUDA_VISIBLE_DEVICES"] = ",".join(ids[:chips])


def card_line() -> str:
    """``name, power limit`` of the first card, from nvidia-smi."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi failed: {e}"
    return out.strip().splitlines()[0] if out.strip() else ""


def measure(spec: dict, seed: int, seconds: float, trace_on: bool,
            devices: list, t0: float) -> dict:
    """Set up, run the window, read the metrics and check the outputs.
    ``t0``: the ``perf_counter`` reading at the process's start.
    Returns the result line's fields (``device`` without the card's
    name)."""
    import torch

    cfg, traffic, cell = spec["cfg"], spec["traffic"], spec["cell"]
    entry = importlib.import_module(f"portbench.entries.{traffic['entry']}")
    spans = trace.Spans()
    program = entry.Cell(cfg, traffic, seed, devices, spans)
    program.setup()
    cuda = [d for d in devices if d.type == "cuda"]
    for d in cuda:
        torch.cuda.synchronize(d)
        torch.cuda.reset_peak_memory_stats(d)
    setup_s = time.perf_counter() - t0

    step_s, images = [], 0
    with trace.DeviceTrace(trace_on and bool(cuda)) as dev_trace:
        lo_ns = time.time_ns()
        start = time.perf_counter()
        while True:
            s0 = time.perf_counter()
            images += program.step()
            step_s.append(time.perf_counter() - s0)
            if time.perf_counter() - start >= seconds:
                break
        window_s = time.perf_counter() - start
        hi_ns = time.time_ns()
    peak = max((torch.cuda.max_memory_allocated(d) for d in cuda),
               default=0)
    events = trace.clip(dev_trace.events, lo_ns, hi_ns)
    cards = len(devices)
    busy = trace.busy_seconds(events, cards)
    ctx = {"cfg": cfg, "traffic": traffic, "cell": cell, "images": images,
           "steps": len(step_s), "window_s": window_s, "setup_s": setup_s,
           "spans": spans, "lo_ns": lo_ns, "hi_ns": hi_ns,
           "events": events, "busy_s": busy, "cards": cards,
           "traced": bool(dev_trace.events), "peak_bytes": peak,
           "family": entry.reference_family(cfg)}
    metrics = {}
    for m in metrics_of(spec["bench"], cell["name"], trace_on):
        value = reader(m["name"]).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    bad = nonfinite(r for step in program.records for r in step)
    failed = len(bad)
    if bad:
        print(f"non-finite outputs of {failed} images: "
              f"{sorted(set().union(*bad))}", file=sys.stderr)

    diag = {"step_s": step_s, "window_s": window_s}
    if dev_trace.events:
        first = min(e[1] for e in dev_trace.events)
        diag["first_event_after_window_start_ms"] = (first - lo_ns) / 1e6
        diag["events"] = len(dev_trace.events)
    print(f"steps {json.dumps(diag)}", file=sys.stderr)

    sides = program.checked()
    pool = program.pool
    program.free()
    t_ref = time.perf_counter()
    refs = entry.reference_records(cfg, traffic, seed, devices[0], pool,
                                   sides)
    print(f"reference: {len(sides)} images in "
          f"{time.perf_counter() - t_ref:.3f} s", file=sys.stderr)
    correct, checks = compare.judge(compare.numbers(sides, refs),
                                    spec["limits"])
    out = {"correct": correct and failed == 0, "attempted": images,
           "failed": failed, "metrics": metrics,
           "device": {"count": cards, "memory_peak_bytes": peak}}
    if trace_on:
        out["device"]["busy_s"] = sum(busy) / cards
        out["device"]["window_s"] = window_s
        out["breakdown"] = trace.breakdown(events, spans, lo_ns, hi_ns,
                                           cards)
    out["checks"] = checks
    return out


def parse(argv):
    p = argparse.ArgumentParser("portbench")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv, t0: float) -> int:
    args = parse(argv)
    spec = load_cell(args.workload)
    chips = spec["cell"]["chips"]
    pin_cards(chips)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() != chips:
        print(f"portbench: the cell needs {chips} CUDA card(s); "
              f"available={torch.cuda.is_available()}, "
              f"count={torch.cuda.device_count()}", file=sys.stderr)
        return 2
    card = card_line()
    print(f"card: {card}", file=sys.stderr)
    devices = [torch.device("cuda", i) for i in range(chips)]
    out = measure(spec, args.seed, args.seconds, bool(args.trace), devices,
                  t0)
    found = forbidden_modules()
    if found:
        print(f"portbench: the run loaded {found}; no run may load JAX or "
              f"the JAX package", file=sys.stderr)
        return 3
    out["device"] = {"platform": "gpu",
                     "kind": torch.cuda.get_device_name(0),
                     **out["device"], "power_limit_w": power_limit(card)}
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(result_line(out), flush=True)
    return 0


def power_limit(card: str):
    """The watts of a ``name, 700.00 W`` card line, or None."""
    try:
        return float(card.rsplit(",", 1)[1].split()[0])
    except (IndexError, ValueError):
        return None


def result_line(out: dict) -> str:
    """The result as one JSON line; a compared number that is not finite
    is written as a string ("inf", "nan"), as JSON has no such number."""
    out = dict(out, checks={
        n: {k: v if math.isfinite(v) else repr(v) for k, v in c.items()}
        for n, c in out["checks"].items()})
    return json.dumps(out, allow_nan=False)
