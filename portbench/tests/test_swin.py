"""Swin-B's additions to the benchmark, on the CPU: the plain reference
(``reference/swin.py``) against the program at a 32 px test Swin
(``configs/tiny_swin.json``: a shifted, masked stage 0 and a stage 1
whose shift is dropped) on the benchmark's seeded weights; its counts at
the published widths; the readers of the windowed-attention counters; a
whole run of the Swin cell's entry; and the reference's imports."""
import math
import sys
import time

import numpy as np
import pytest
import torch

import xai_tpu_torch.utils
from portbench import harness
from portbench.metrics import (masked_window_rows_per_image,
                               window_attn_rows_per_image)
from portbench.reference import swin
from portbench.weights import make_weights
from xai_tpu_torch.utils import trace

from .helpers import HERE, load, make_spec
from .test_imports import _modules_after
from .test_reference import _rel, _setup

READERS = (window_attn_rows_per_image, masked_window_rows_per_image)


@pytest.fixture
def tiny_swin(monkeypatch):
    """The program's ``swin_tiny`` at the size of
    ``configs/tiny_swin.json``."""
    from xai_tpu_torch.models import swin as program_swin
    cfg = load(HERE / "configs" / "tiny_swin.json")
    monkeypatch.setitem(program_swin.ARCHS, "swin_tiny", dict(
        depths=tuple(cfg["depths"]), num_heads=tuple(cfg["num_heads"]),
        embed_dim=cfg["embed_dim"], window=cfg["window_size"],
        img_hw=cfg["img_hw"]))
    return cfg


def test_forward(tiny_swin):
    """Within 1e-5 of the largest |logit| (float32 rounding)."""
    cfg, _, bundle, ref, _, xs = _setup("tiny_swin", "ig_b4")
    x = xs.permute(0, 3, 1, 2).contiguous()
    with torch.no_grad():
        assert _rel(bundle.apply(x), ref.forward(x)) < 1e-5


def test_ig_single_and_batched(tiny_swin):
    """Within 1e-4 of the reference's map: the order of summing 50
    gradients."""
    from xai_tpu_torch.methods.batch import ig_lig_batch
    from xai_tpu_torch.methods.gradient import ig, to_saliency
    cfg, _, bundle, ref, _, xs = _setup("tiny_swin", "ig_b4")
    targets = [3, 500, 999]
    batched = ig_lig_batch(bundle, xs, torch.tensor(targets)).numpy()
    for i, t in enumerate(targets):
        want = ref.attribute(xs[i].permute(2, 0, 1), t)
        assert _rel(to_saliency(ig(bundle, xs[i], t)), want) < 1e-4
        assert _rel(batched[i], want) < 1e-4


def test_battery_scores(tiny_swin):
    from xai_tpu_torch.metrics.curves import run_battery
    from xai_tpu_torch.ops.blur import make_blur_fn
    cfg, t, bundle, ref, _, xs = _setup("tiny_swin", "ig_b4")
    rng = np.random.default_rng(0)
    for i in range(2):
        sal = rng.random((cfg["img_hw"],) * 2).astype(np.float32)
        with torch.no_grad():
            target = int(bundle.apply(xs[i:i + 1].permute(0, 3, 1, 2))
                         .argmax())
        got = run_battery(bundle.apply, xs[i], sal, make_blur_fn(31, 31.0),
                          chunk=45, target=target)
        want = ref.scores(xs[i].permute(2, 0, 1), sal, target)
        assert set(got) == set(want)
        for k in want:
            assert got[k] == pytest.approx(want[k], abs=1e-5), k


def test_a_swin_run_is_correct(tiny_swin):
    """The Swin cell's traffic through ``harness.measure`` on the CPU,
    held to ``swinb_ig_b4``'s limits."""
    spec = make_spec("tiny_swin", "ig_b4", "swinb_ig_b4")
    out = harness.measure(spec, 2 ** 31 + 23, 0.0, False,
                          [torch.device("cpu")], time.perf_counter())
    assert out["correct"], out["checks"]


def test_published_counts():
    """15,430,946,816 MACs a forward and 87,768,224 parameters at
    ``configs/swin_b.json`` (Swin-B as published: 15.4 G, 88 M)."""
    cfg = load(HERE.parent / "configs" / "swin_b.json")
    assert swin.macs(cfg) == 15430946816
    assert sum(math.prod(s) for _, s, _ in swin.param_spec(cfg)) == \
        cfg["published"]["parameters"] == 87768224


def test_tiny_macs_hand_worked():
    """Stage 0: 8 x 8 tokens of width 16 in windows of 16; stage 1:
    merging to 4 x 4 of width 32, windows of 16; the 48-MAC patches."""
    cfg = load(HERE / "configs" / "tiny_swin.json")

    def block(t, d, n):
        return t * 4 * d * d + 2 * t * n * d + 2 * t * d * 4 * d

    want = (64 * 16 * 48 + 2 * block(64, 16, 16) + 16 * 64 * 32
            + 2 * block(16, 32, 16) + 1000 * 32)
    assert swin.macs(cfg) == want


def test_the_shift_is_dropped_where_the_window_covers_the_grid():
    cfg = load(HERE.parent / "configs" / "swin_b.json")
    shifts = [[swin.shift_of(cfg, b, res, ws) for b in range(depth)]
              for _, depth, _, _, res, ws in swin.stages(cfg)]
    assert shifts == [[0, 3], [0, 3], [0, 3] * 9, [0, 0]]


def test_zero_image_gradient_is_finite_at_swin_b_depth():
    """IG's first row is the zero image.  At Swin-B's depth and 224 px
    (width cut to 16 here), the benchmark's weights give it a finite input
    gradient; with every bias zero, every activation is 0 and the
    gradient overflows through the LayerNorms in series."""
    cfg = dict(load(HERE.parent / "configs" / "swin_b.json"), embed_dim=16,
               num_heads=[1, 1, 2, 2])
    spec = swin.param_spec(cfg)
    zero_biases = [(n, s, "zero" if k == "shift" else k)
                   for n, s, k in spec]
    for spec_, finite in ((spec, True), (zero_biases, False)):
        w = make_weights(spec_, cfg["init"], 7, torch.device("cpu"))
        x = torch.zeros(1, 3, 224, 224, requires_grad=True)
        swin.forward(w, cfg, x)[0, 3].backward()
        assert bool(torch.isfinite(x.grad).all()) is finite


def _span(i, parent, s, e, rows):
    return trace.Span(i, parent, "battery", "MainThread", None, s, e,
                      dict(zip(("window_attn_rows", "masked_window_rows"),
                               rows[0])),
                      dict(zip(("window_attn_rows", "masked_window_rows"),
                               rows[1])))


def _ctx(images=2):
    return {"lo_ns": 100, "hi_ns": 1000, "images": images}


# two top-level spans in [100, 1000) and a child, whose rows are inside
# its parent's; a span of the set-up before the window
SPANS = [_span(1, None, 100, 400, ((0, 0), (11466, 5684))),
         _span(2, None, 400, 900, ((11466, 5684), (22932, 11368))),
         _span(3, 2, 500, 600, ((11466, 5684), (17000, 8000))),
         _span(4, None, 10, 20, ((0, 0), (99, 99)))]


def test_readers_count_top_level_spans(monkeypatch):
    monkeypatch.setattr(trace, "_RECORDS", SPANS)
    assert window_attn_rows_per_image.read(_ctx()) == 11466
    assert masked_window_rows_per_image.read(_ctx()) == 5684
    assert window_attn_rows_per_image.read(_ctx(images=1)) == 22932


@pytest.mark.parametrize("reader", READERS, ids=lambda r: r.__name__)
def test_readers_read_nothing_without_the_counter(reader, monkeypatch):
    """Spans that never saw the counter (a model without windowed
    attention, or a program without the counter) read nothing, as does
    a program without the trace module."""
    bare = [s._replace(counts_start={"model_rows": 0},
                       counts_end={"model_rows": 5}) for s in SPANS]
    monkeypatch.setattr(trace, "_RECORDS", bare)
    assert reader.read(_ctx()) is None
    monkeypatch.setattr(trace, "_RECORDS", SPANS)
    assert reader.read(_ctx()) is not None
    monkeypatch.delattr(xai_tpu_torch.utils, "trace")
    monkeypatch.setitem(sys.modules, "xai_tpu_torch.utils.trace", None)
    assert reader.read(_ctx()) is None


def test_reference_swin_loads_nothing_of_the_program():
    top = _modules_after("import portbench.reference.swin")
    assert not top & {"xai_tpu_torch", "xai_tpu", "jax", "jaxlib", "flax"}
