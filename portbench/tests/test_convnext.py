"""ConvNeXt-B's additions to the benchmark, on the CPU: the plain reference
(``reference/convnext.py``): its counts at the published widths and by
hand at a 32 px test ConvNeXt (``configs/tiny_convnext.json``: stage 1's
4 x 4 grid is smaller than the 7x7 depthwise kernel), its weights' kinds;
the reader of the block counter; a whole run of the ConvNeXt cell's entry
at the test size, where the reference is held against the program on the
benchmark's seeded weights; and the reference's imports."""
import math
import sys
import time

import pytest
import torch

import xai_tpu_torch.utils
from portbench import harness
from portbench.metrics import cnblock_rows_per_image
from portbench.reference import convnext
from xai_tpu_torch.utils import trace

from .helpers import HERE, load, make_spec
from .test_imports import _modules_after


@pytest.fixture
def tiny_convnext(monkeypatch):
    """The program's ``CONVNXT`` at the size of
    ``configs/tiny_convnext.json``."""
    from xai_tpu_torch.models import convnext as program_convnext
    cfg = load(HERE / "configs" / "tiny_convnext.json")
    monkeypatch.setitem(program_convnext.ARCHS, "convnext_base", dict(
        depths=tuple(cfg["depths"]), dims=tuple(cfg["dims"])))
    return cfg


def test_a_convnext_run_is_correct(tiny_convnext):
    """The ConvNeXt cell's traffic through ``harness.measure`` on the CPU,
    held to ``convnextb_ig_b4``'s limits."""
    spec = make_spec("tiny_convnext", "ig_b4", "convnextb_ig_b4")
    out = harness.measure(spec, 2 ** 31 + 31, 0.0, False,
                          [torch.device("cpu")], time.perf_counter())
    assert out["correct"], out["checks"]


def test_published_counts():
    """15,354,729,472 MACs a forward (torchvision's 15.35 G) and
    88,591,464 parameters at ``configs/convnext_b.json``."""
    cfg = load(HERE.parent / "configs" / "convnext_b.json")
    assert convnext.macs(cfg) == 15354729472
    assert abs(convnext.macs(cfg) / 1e9 - cfg["published"]
               ["gmac_per_forward"]) < 0.005
    assert sum(math.prod(s) for _, s, _ in convnext.param_spec(cfg)) == \
        cfg["published"]["parameters"] == 88591464


def test_tiny_macs_hand_worked():
    """Stem: 8 x 8 pixels of 16 outputs over 3 x 4 x 4 inputs; stage 0
    (width 16, hidden 64): two blocks on 64 pixels, each 49 depthwise
    taps and two 16 x 64 products a pixel; the 2x2 downsampling to 32 on
    16 pixels; stage 1 (width 32, hidden 128): one block on 16 pixels;
    the head 32 x 1000."""
    cfg = load(HERE / "configs" / "tiny_convnext.json")
    want = (64 * 16 * 48
            + 2 * 64 * (16 * 49 + 2 * 16 * 64)
            + 16 * 16 * 32 * 4
            + 16 * (32 * 49 + 2 * 32 * 128)
            + 32 * 1000)
    assert convnext.macs(cfg) == want


def test_stages_follow_the_grid():
    cfg = load(HERE / "configs" / "tiny_convnext.json")
    assert list(convnext.stages(cfg)) == [(0, 2, None, 16, 8),
                                          (1, 1, 16, 32, 4)]
    cfg = load(HERE.parent / "configs" / "convnext_b.json")
    assert [(d, s) for _, d, _, _, s in convnext.stages(cfg)] == \
        [(3, 56), (3, 28), (27, 14), (3, 7)]


def test_layer_scale_is_the_branch_scale():
    """``gamma`` is drawn as ``branch_scale`` from the configuration's
    ``init``, every bias but the head's as a ``shift``."""
    cfg = load(HERE.parent / "configs" / "convnext_b.json")
    kinds = {n: k for n, _, k in convnext.param_spec(cfg)}
    assert {n for n, k in kinds.items() if k == "branch_scale"} == {
        n for n in kinds if n.endswith(".gamma")} and len(
        [n for n in kinds if n.endswith(".gamma")]) == 36
    assert {n for n, k in kinds.items() if n.endswith(".bias")
            and k != "shift"} == {"head.bias"}
    assert "branch_scale" in cfg["init"]
    assert set(cfg["assumed"]) == {"init.head_gain", "init.branch_scale"}


def _span(i, parent, s, e, rows):
    return trace.Span(i, parent, "battery", "MainThread", None, s, e,
                      {"cnblock_rows": rows[0]}, {"cnblock_rows": rows[1]})


def _ctx(images=2):
    return {"lo_ns": 100, "hi_ns": 1000, "images": images}


# two top-level spans in [100, 1000) and a child, whose rows are inside
# its parent's; a span of the set-up before the window
SPANS = [_span(1, None, 100, 400, (0, 17199)),
         _span(2, None, 400, 900, (17199, 34398)),
         _span(3, 2, 500, 600, (17199, 20000)),
         _span(4, None, 10, 20, (0, 99))]


def test_reader_counts_top_level_spans(monkeypatch):
    monkeypatch.setattr(trace, "_RECORDS", SPANS)
    assert cnblock_rows_per_image.read(_ctx()) == 17199
    assert cnblock_rows_per_image.read(_ctx(images=1)) == 34398


def test_reader_reads_nothing_without_the_counter(monkeypatch):
    """Spans that never saw the counter (a model without ConvNeXt blocks,
    or a program without the counter) read nothing, as does a program
    without the trace module."""
    bare = [s._replace(counts_start={"model_rows": 0},
                       counts_end={"model_rows": 5}) for s in SPANS]
    monkeypatch.setattr(trace, "_RECORDS", bare)
    assert cnblock_rows_per_image.read(_ctx()) is None
    monkeypatch.setattr(trace, "_RECORDS", SPANS)
    assert cnblock_rows_per_image.read(_ctx()) is not None
    monkeypatch.delattr(xai_tpu_torch.utils, "trace")
    monkeypatch.setitem(sys.modules, "xai_tpu_torch.utils.trace", None)
    assert cnblock_rows_per_image.read(_ctx()) is None


def test_reference_convnext_loads_nothing_of_the_program():
    top = _modules_after("import portbench.reference.convnext")
    assert not top & {"xai_tpu_torch", "xai_tpu", "jax", "jaxlib", "flax"}
