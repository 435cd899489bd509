"""MaxViT-T's additions to the benchmark, on the CPU: the plain reference
(``reference/maxvit.py``) against the program at a 32 px test MaxViT
(``configs/tiny_maxvit.json``: 4 windows and 4 grid groups in stage 0, one
window in stage 1) on the benchmark's seeded weights; its counts at the
published widths; the readers of the grid-attention and MBConv counters;
a whole run of the MaxViT cell's entry; and the reference's imports."""
import math
import sys
import time

import numpy as np
import pytest
import torch

import xai_tpu_torch.utils
from portbench import harness
from portbench.metrics import grid_attn_rows_per_image, mbconv_rows_per_image
from portbench.reference import maxvit
from xai_tpu_torch.utils import trace

from .helpers import HERE, load, make_spec
from .test_imports import _modules_after
from .test_reference import _rel, _setup

READERS = (grid_attn_rows_per_image, mbconv_rows_per_image)
COUNTERS = ("grid_attn_rows", "mbconv_rows")


@pytest.fixture
def tiny_maxvit(monkeypatch):
    """The program's ``MAXVIT`` at the size of
    ``configs/tiny_maxvit.json``."""
    from xai_tpu_torch.models import maxvit as program_maxvit
    cfg = load(HERE / "configs" / "tiny_maxvit.json")
    monkeypatch.setattr(program_maxvit, "TV_ARCH", dict(
        depths=tuple(cfg["depths"]), dims=tuple(cfg["dims"]),
        stem_dim=cfg["stem_dim"], window=cfg["partition"],
        head_dim=cfg["head_dim"], num_classes=cfg["num_classes"],
        img_hw=cfg["img_hw"]))
    return cfg


def test_forward(tiny_maxvit):
    """Within 1e-5 of the largest |logit| (float32 rounding)."""
    cfg, _, bundle, ref, _, xs = _setup("tiny_maxvit", "ig_b4")
    x = xs.permute(0, 3, 1, 2).contiguous()
    with torch.no_grad():
        assert _rel(bundle.apply(x), ref.forward(x)) < 1e-5


def test_ig_single_and_batched(tiny_maxvit):
    """Within 1e-4 of the reference's map: the order of summing 50
    gradients."""
    from xai_tpu_torch.methods.batch import ig_lig_batch
    from xai_tpu_torch.methods.gradient import ig, to_saliency
    cfg, _, bundle, ref, _, xs = _setup("tiny_maxvit", "ig_b4")
    targets = [3, 500, 999]
    batched = ig_lig_batch(bundle, xs, torch.tensor(targets)).numpy()
    for i, t in enumerate(targets):
        want = ref.attribute(xs[i].permute(2, 0, 1), t)
        assert _rel(to_saliency(ig(bundle, xs[i], t)), want) < 1e-4
        assert _rel(batched[i], want) < 1e-4


def test_battery_scores(tiny_maxvit):
    from xai_tpu_torch.metrics.curves import run_battery
    from xai_tpu_torch.ops.blur import make_blur_fn
    cfg, t, bundle, ref, _, xs = _setup("tiny_maxvit", "ig_b4")
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


def test_a_maxvit_run_is_correct(tiny_maxvit):
    """The MaxViT cell's traffic through ``harness.measure`` on the CPU,
    held to ``maxvitt_ig_b4``'s limits."""
    spec = make_spec("tiny_maxvit", "ig_b4", "maxvitt_ig_b4")
    out = harness.measure(spec, 2 ** 31 + 29, 0.0, False,
                          [torch.device("cpu")], time.perf_counter())
    assert out["correct"], out["checks"]


def test_published_counts():
    """5,558,046,720 MACs a forward (torchvision's 5.56 G) and 30,919,624
    parameters at ``configs/maxvit_t.json``."""
    cfg = load(HERE.parent / "configs" / "maxvit_t.json")
    assert maxvit.macs(cfg) == 5558046720
    assert abs(maxvit.macs(cfg) / 1e9 - cfg["published"]
               ["gmac_per_forward"]) < 0.03 * 5.56
    assert sum(math.prod(s) for _, s, _ in maxvit.param_spec(cfg)) == \
        cfg["published"]["parameters"] == 30919624


def test_tiny_macs_hand_worked():
    """Stem at 16 x 16; stage 0 (width 16, mid 64, squeeze 4): a stride-2
    block from 16 x 16 to 8 x 8 with its shortcut, a block at 8 x 8;
    stage 1 (width 32, mid 128, squeeze 8): a stride-2 block from 8 x 8
    to 4 x 4; attention in groups of 16 tokens; the head."""
    cfg = load(HERE / "configs" / "tiny_maxvit.json")

    def attn(t, d, n):
        return 2 * (4 * t * d * d + 2 * t * n * d + 2 * t * d * 4 * d)

    def mbconv(res, cin, d, t, shortcut):
        mid = 4 * d
        return (res * res * cin * mid + t * mid * 9 + 2 * mid * (d // 4)
                + t * mid * d + shortcut * t * cin * d)

    want = (256 * 16 * 27 + 256 * 16 * 16 * 9
            + mbconv(16, 16, 16, 64, True) + attn(64, 16, 16)
            + mbconv(8, 16, 16, 64, False) + attn(64, 16, 16)
            + mbconv(8, 16, 32, 16, True) + attn(16, 32, 16)
            + 32 * 32 + 1000 * 32)
    assert maxvit.macs(cfg) == want


def test_windows_shrink_to_the_grid():
    cfg = load(HERE / "configs" / "tiny_maxvit.json")
    assert [(s, b, out, ws) for s, b, *_, out, ws in maxvit.blocks(cfg)] \
        == [(0, 0, 8, 4), (0, 1, 8, 4), (1, 0, 4, 4)]
    cfg = load(HERE.parent / "configs" / "maxvit_t.json")
    assert [out for *_, out, _ in maxvit.blocks(cfg)] == \
        [56, 56, 28, 28, 14, 14, 14, 14, 14, 7, 7]


def test_grid_groups_hold_tokens_a_stride_apart():
    """A grid group of an 8 x 8 map at partition 4 holds the 4 x 4 tokens
    2 apart; the reverse puts every token back."""
    x = torch.arange(64.0).view(1, 8, 8, 1)
    g = maxvit._grid(x, 4)
    assert g.shape == (4, 16, 1)
    assert g[0, :, 0].tolist() == [8 * r + c for r in range(0, 8, 2)
                                   for c in range(0, 8, 2)]
    assert torch.equal(maxvit._ungrid(g, 4, 1, 8, 8), x)


def _span(i, parent, s, e, rows):
    return trace.Span(i, parent, "battery", "MainThread", None, s, e,
                      dict(zip(COUNTERS, rows[0])),
                      dict(zip(COUNTERS, rows[1])))


def _ctx(images=2):
    return {"lo_ns": 100, "hi_ns": 1000, "images": images}


# two top-level spans in [100, 1000) and a child, whose rows are inside
# its parent's; a span of the set-up before the window
SPANS = [_span(1, None, 100, 400, ((0, 0), (8918, 21413))),
         _span(2, None, 400, 900, ((8918, 21413), (17836, 42826))),
         _span(3, 2, 500, 600, ((8918, 21413), (9000, 30000))),
         _span(4, None, 10, 20, ((0, 0), (99, 99)))]


def test_readers_count_top_level_spans(monkeypatch):
    monkeypatch.setattr(trace, "_RECORDS", SPANS)
    assert grid_attn_rows_per_image.read(_ctx()) == 8918
    assert mbconv_rows_per_image.read(_ctx()) == 21413
    assert mbconv_rows_per_image.read(_ctx(images=1)) == 42826


@pytest.mark.parametrize("reader", READERS, ids=lambda r: r.__name__)
def test_readers_read_nothing_without_the_counter(reader, monkeypatch):
    """Spans that never saw the counter (a model without MaxViT's layers,
    or a program without the counter) read nothing, as does a program
    without the trace module."""
    bare = [s._replace(counts_start={"model_rows": 0},
                       counts_end={"model_rows": 5}) for s in SPANS]
    monkeypatch.setattr(trace, "_RECORDS", bare)
    assert reader.read(_ctx()) is None
    monkeypatch.setattr(trace, "_RECORDS", SPANS)
    assert reader.read(_ctx()) is not None
    monkeypatch.delattr(xai_tpu_torch.utils, "trace")
    monkeypatch.setitem(sys.modules, "xai_tpu_torch.utils.trace", None)
    assert reader.read(_ctx()) is None


def test_reference_maxvit_loads_nothing_of_the_program():
    top = _modules_after("import portbench.reference.maxvit")
    assert not top & {"xai_tpu_torch", "xai_tpu", "jax", "jaxlib", "flax"}
