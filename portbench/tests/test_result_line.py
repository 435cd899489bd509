"""The last line's format, and the refusals of ``run.py``."""
import json
import math
import os
import subprocess
import sys

import pytest

from portbench import harness

from .helpers import make_spec


def _out(**checks):
    return {"correct": True, "attempted": 8, "failed": 0,
            "metrics": {"images_per_s": {"value": 2.5, "unit": "images/s"}},
            "device": {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3",
                       "count": 1, "memory_peak_bytes": 123},
            "checks": {k: {"value": v, "limit": 1e-3}
                       for k, v in checks.items()}}


def test_result_line_keys_and_order():
    line = harness.result_line(_out(pred_gap=0.0, map_err=1e-4))
    obj = json.loads(line)
    assert "\n" not in line
    assert list(obj)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(obj)
    assert obj["checks"]["map_err"] == {"value": 1e-4, "limit": 1e-3}


def test_result_line_writes_non_finite_numbers_as_strings():
    obj = json.loads(harness.result_line(_out(score_gap=math.inf,
                                              map_err=math.nan)))
    assert obj["checks"]["score_gap"]["value"] == "inf"
    assert obj["checks"]["map_err"]["value"] == "nan"


@pytest.mark.parametrize("card,watts", [
    ("NVIDIA H100 80GB HBM3, 700.00 W", 700.0),
    ("NVIDIA H100 80GB HBM3, [N/A]", None), ("", None)])
def test_power_limit(card, watts):
    assert harness.power_limit(card) == watts


def test_metrics_of_a_cell():
    bench = {"end_to_end": [{"name": "a"}, {"name": "b", "workloads": ["x"]}],
             "per_layer": [{"name": "c", "workloads": ["y"], "moves": "a"},
                           {"name": "d", "moves": "b"},
                           {"name": "e", "moves": "a"}]}
    assert [m["name"] for m in harness.metrics_of(bench, "x", False)] == [
        "a", "b"]
    assert [m["name"] for m in harness.metrics_of(bench, "x", True)] == [
        "d", "e"]
    assert [m["name"] for m in harness.metrics_of(bench, "y", True)] == [
        "c", "e"]


def test_split_metrics_share_a_reader():
    assert harness.reader("device_idle_pct.mesh") is \
        harness.reader("device_idle_pct")


def test_run_without_a_card_prints_no_result(tmp_path):
    """With no CUDA card the run exits 2 and prints nothing on stdout."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, str(harness.HERE / "run.py"),
                        "--workload", "r101_ig_b4", "--seed", "3",
                        "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, env=env,
                       cwd=tmp_path, timeout=300)
    assert p.returncode == 2, p.stderr
    assert p.stdout == ""
    assert "CUDA card" in p.stderr


def test_a_cpu_run_gives_every_field(tiny_vit):
    """The rest of a run on the CPU: the fields of the last line, the
    per-layer metrics of a traced run that need no device trace."""
    import time

    import torch
    spec = make_spec("tiny_vit", "rollout_b4", "vit16_rollout_b4")
    out = harness.measure(spec, 2 ** 33 + 1, 0.0, True,
                          [torch.device("cpu")], time.perf_counter())
    obj = json.loads(harness.result_line(out))
    assert obj["correct"] is True and obj["failed"] == 0
    assert obj["attempted"] == 4
    assert set(obj["metrics"]) == {"attr_s_per_image", "battery_s_per_image",
                                   "step_mfu_pct"}
    assert obj["device"]["window_s"] > 0
    assert set(obj["breakdown"]) == {"device_ops", "idle_gaps"}
    assert list(obj)[-1] == "checks"


@pytest.mark.parametrize("listed,chips,visible", [
    (None, 1, "0"), (None, 4, "0,1,2,3"), ("5,6,7,2,3", 4, "5,6,7,2"),
    ("3,1", 1, "3"), ("", 1, "")])
def test_a_run_sees_only_its_cells_cards(listed, chips, visible):
    env = {} if listed is None else {"CUDA_VISIBLE_DEVICES": listed}
    harness.pin_cards(chips, env)
    assert env["CUDA_VISIBLE_DEVICES"] == visible
