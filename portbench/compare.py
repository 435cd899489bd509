"""The numbers that decide ``correct``, each held to a limit of its
cell's ``portbench/limits/<cell>.json``.

For each compared image, the judged side (the program, or the control
in its place) and the reference:

- ``pred_gap``: the larger of |the side's probability of its target -
  the reference's probability of that class| and the reference's best
  probability less its probability of the side's target (a target that
  is not the reference's top class shows here);
- ``map_err``: the largest |side map - reference map| over the pixels,
  over the reference map's largest |value|;
- ``score_gap``: the largest |side score - reference score| over the 10
  scores (a score that is NaN on both sides agrees; on one side, it
  reads infinite).

Each number is the largest over the compared images.
"""
from __future__ import annotations

import math

import numpy as np

NAMES = ("pred_gap", "map_err", "score_gap")


def _score_gap(a: float, b: float) -> float:
    if math.isnan(a) and math.isnan(b):
        return 0.0
    if math.isnan(a) or math.isnan(b):
        return math.inf
    return abs(a - b)


def numbers(sides: list, refs: list) -> dict:
    """``{name: largest value}`` over the compared images."""
    out = dict.fromkeys(NAMES, 0.0)
    for s, r in zip(sides, refs, strict=True):
        p = r["probs"]
        pred = max(abs(s["pred"] - p[s["target"]]),
                   p.max() - p[s["target"]])
        ref_map = np.asarray(r["map"], np.float64)
        err = np.abs(np.asarray(s["map"], np.float64) - ref_map).max() \
            / max(np.abs(ref_map).max(), 1e-30)
        gap = max(_score_gap(s["scores"][k], r["scores"][k])
                  for k in r["scores"])
        if not np.isfinite(np.asarray(s["map"])).all():
            err = math.inf
        for name, v in zip(NAMES, (pred, err, gap)):
            v = float(v)
            out[name] = max(out[name], math.inf if math.isnan(v) else v)
    return out


def score_gaps(sides: list, refs: list) -> dict:
    """The largest gap of each of the 10 scores over the compared images
    (``calibrate.py`` prints them beside ``score_gap``)."""
    return {k: max(_score_gap(s["scores"][k], r["scores"][k])
                   for s, r in zip(sides, refs, strict=True))
            for k in refs[0]["scores"]}


def judge(values: dict, limits: dict) -> tuple:
    """(correct, ``{name: {"value", "limit"}}``): every number at or
    under its limit."""
    checks = {n: {"value": values[n], "limit": limits[n]} for n in NAMES}
    return all(c["value"] <= c["limit"] for c in checks.values()), checks
