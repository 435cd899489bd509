"""Every cell of ``BENCHMARK.json`` loads by name with its configuration,
traffic mix, entry, limits and metric readers, and the file keeps to the
benchmark's contract (names, keys, lengths, the chip-time budget)."""
import importlib
import json
import math
import re

import pytest
import torch

from portbench import compare, harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = harness.load_json(harness.REPO / "BENCHMARK.json")
CELLS = [c["name"] for c in BENCH["workloads"]]


def test_top_level_keys_and_size():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert len(json.dumps(BENCH)) <= 64 * 1024
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51


def test_run_seconds_fit_a_full_check():
    # a check of the full 24 cells: 2 + 14 x 24 runs, each its seconds
    # plus 60, 2 x 90 s of compiling a cell, 1200 s spare
    rs = BENCH["run_seconds"]
    assert (2 + 14 * 24) * (rs + 60) + 24 * 180 + 1200 <= 43200


@pytest.mark.parametrize("cell", CELLS)
def test_cell_loads(cell):
    spec = harness.load_cell(cell, BENCH)
    t = spec["traffic"]
    assert spec["cell"]["chips"] in (1, 4)
    entry = importlib.import_module(f"portbench.entries.{t['entry']}")
    assert hasattr(entry, "Cell") and hasattr(entry, "reference_records")
    assert set(spec["limits"]) == set(compare.NAMES)
    assert all(0 < v < math.inf for v in spec["limits"].values())
    fam = entry.reference_family(spec["cfg"])
    assert fam.__name__ == f"portbench.reference.{spec['cfg']['family']}"
    importlib.import_module(f"portbench.reference.{t['attr_func']}")
    assert t["image_batch"] % t.get("check_per_step", t["image_batch"]) == 0


def test_unknown_cell_is_refused():
    with pytest.raises(KeyError, match="no workload"):
        harness.load_cell("no_such_cell", BENCH)


def test_names_units_and_lengths():
    names = []
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/configs/")
        assert c["reduced"] == []
        names.append(c["name"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["traffic"]) and w["config"] in names
        names.append(w["name"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        names.append(m["name"])
    assert all(NAME.match(n) for n in names)
    assert len(names) == len(set(names))
    for text in ([c["why"] for c in BENCH["configs"] + BENCH["workloads"]]
                 + [c["source"] for c in BENCH["configs"]]
                 + [m["layer"] for m in BENCH["per_layer"]]):
        assert 1 <= len(text) <= 200 and "\n" not in text
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(
        1, len(BENCH["workloads"]) // 4)


def test_metrics_have_readers_and_bounds():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert callable(harness.reader(m["name"]).read)


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_reports_enough(cell):
    """setup_s, another end-to-end metric, and per-layer metrics that
    each move one this cell reports."""
    e2e = {m["name"] for m in harness.metrics_of(BENCH, cell, False)}
    assert "setup_s" in e2e and len(e2e) >= 2
    per_layer = harness.metrics_of(BENCH, cell, True)
    assert per_layer and all(m["moves"] in e2e for m in per_layer)
    layers = {}
    for m in BENCH["per_layer"]:
        assert layers.setdefault(m["name"].split(".")[0], m["layer"]) == \
            m["layer"]


@pytest.mark.parametrize("name,arch", [("r101", "resnet101"),
                                       ("vit_b16", "vit_base_patch16_224")])
def test_weights_spec_matches_the_program(name, arch):
    """The reference's weight list loads into the program's module
    strictly: the same names and shapes."""
    from portbench.entries.perturbation import reference_family
    cfg = harness.load_json(harness.HERE / "configs" / f"{name}.json")
    spec = reference_family(cfg).param_spec(cfg)
    family = importlib.import_module(
        f"xai_tpu_torch.models.{cfg['family']}")
    with torch.device("meta"):
        model = family.make_model(arch)
    state = model.state_dict()
    assert {n: tuple(s) for n, s, _ in spec} == {
        n: tuple(t.shape) for n, t in state.items()}
    assert sum(math.prod(s) for _, s, _ in spec) == \
        cfg["published"]["parameters"]
