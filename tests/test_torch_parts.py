"""The port's part spans (``xai_tpu_torch/utils/trace.py part``) on the
CPU, at 64 px on TINY_R, TINY_VIT's widths, swin_tiny's, convnext_tiny's
and the small MaxViT's (``portbench/tests/configs/tiny_maxvit.json``, both
forms): nothing recorded without a profiler; under ``profile(activities=
[CPU])`` one forward records only the seven kinds, each a leaf under the
model's call, as many as its layers give; ``backward`` once a
``score_and_grad`` call; no ``device_s`` on the CPU; logits, maps and
battery scores bit-identical with the profiler on and off.

The tests marked ``card`` check that every part of a CUDA forward has a
positive ``device_s`` whose sum is at most the forward's device time, and
that the parts hold few CUDA events at once; on a machine with a card,
run them without this directory's JAX conftest:

    python -m pytest tests/test_torch_parts.py --noconftest -m card -q
"""
import copy
import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from xai_tpu_torch.metrics.curves import run_battery
from xai_tpu_torch.models import convnext, maxvit, swin, vit
from xai_tpu_torch.models.common import (ModelBundle, ModelMeta,
                                         init_flax_default)
from xai_tpu_torch.runners import common
from xai_tpu_torch.utils import trace

from torch_one_thread import one_torch_thread  # noqa: F401 (autouse)

HW = 64
TINY_MAXVIT = json.loads((Path(__file__).resolve().parent.parent
                          / "portbench" / "tests" / "configs"
                          / "tiny_maxvit.json").read_text())
KINDS = {f"part.{k}" for k in trace.PARTS}


def _tiny_r():
    return common.build_bundle("TINY_R", seed=3, device="cpu").module


def _vit():
    cfg = dataclasses.replace(vit.CONFIGS["vit_tiny_patch16_224"],
                              img_hw=HW)
    return vit.init_random(vit.VisionTransformer(cfg), 3)


def _swin():
    # swin_tiny's depths and widths; 4 x 4 windows tile its 16, 8 and 4
    # px grids at 64 px, and the last stage's 2 x 2 grid drops its shift
    return init_flax_default(swin.SwinTransformer(
        window=4, img_hw=HW, **swin.ARCHS["swin_tiny"]), 3)


def _convnext():
    return init_flax_default(convnext.ConvNeXt(
        **convnext.ARCHS["convnext_tiny"]), 3)


def _maxvit(form):
    c = TINY_MAXVIT
    args = (tuple(c["depths"]), tuple(c["dims"]), c["stem_dim"],
            c["partition"])
    if form == "tv":
        module = maxvit.MaxViTTV(*args, c["head_dim"], c["num_classes"],
                                 img_hw=HW)
    else:
        module = maxvit.MaxViT(*args, c["num_classes"], img_hw=HW)
    return init_flax_default(module, 3)


def _resnet_parts(m):
    # stem: conv, epilogue, max-pool; a block: 3 convs and 3 epilogues, and
    # the downsampling conv; head: mean, fc
    blocks = [b for name in ("layer1", "layer2", "layer3", "layer4")
              for b in getattr(m, name)]
    return 3 + sum(6 + (b.downsample_conv is not None) for b in blocks) + 2


def _vit_parts(m):
    # embedding: conv, token layout, + pos; a block: norm1, qkv, attn,
    # proj, add, norm2, fc1, GELU, fc2, add; head: norm, linear
    return 3 + 10 * m.cfg.depth + 2


def _swin_parts(m):
    # patch conv and norm (its copy only under no-grad on a card); a
    # block: norm1, roll + partition, qkv, attn, proj, reverse + roll,
    # add, norm2, fc1, GELU, fc2, add; a merge: gather, norm, reduction;
    # head: norm, mean, linear
    return 2 + 12 * sum(m.depths) + 3 * (len(m.depths) - 1) + 3


def _convnext_parts(m):
    # stem: the NHWC copy, conv, norm; a block: depthwise, norm, pw1, GELU,
    # pw2, layer scale + skip; a downsampling: norm, conv; head: mean,
    # norm, linear
    return 3 + 6 * sum(m.depths) + 2 * (len(m.depths) - 1) + 3


def _maxvit_parts(m):
    # the stem's NHWC copy; stem (tv: conv, BN, GELU, conv; paper: conv,
    # GELU, conv); MBConv (tv: BN, 1x1, BN, GELU, depthwise, BN, GELU, SE,
    # 1x1; paper: LayerNorm, 1x1, GELU, depthwise, GELU, SE, 1x1), its
    # shortcut (pooled: NCHW copy, pool, conv, copy back; else a 1x1
    # where the width changes) and its add; each attention layer: norm,
    # partition, qkv, attn, proj, reverse, add, norm, fc1, GELU, fc2,
    # add; head: mean, norm, head_pre, tanh, head
    tv = isinstance(m, maxvit.MaxViTTV)
    n = 1 + (4 if tv else 3) + 5
    for s, depth in enumerate(m.depths):
        for b in range(depth):
            mb = getattr(m, f"stage{s}_block{b}").mbconv
            short = 0 if mb.shortcut is None else (4 if mb.stride > 1
                                                   else 1)
            n += (9 if tv else 7) + short + 1 + 2 * 12
    return n


MODELS = {"TINY_R": (_tiny_r, _resnet_parts),
          "TINY_VIT": (_vit, _vit_parts),
          "swin_tiny": (_swin, _swin_parts),
          "convnext_tiny": (_convnext, _convnext_parts),
          "maxvit_tv": (lambda: _maxvit("tv"), _maxvit_parts),
          "maxvit_paper": (lambda: _maxvit("paper"), _maxvit_parts)}
# the kinds each model's forward has
FORWARD_KINDS = {
    "TINY_R": {"conv", "norm", "pointwise", "linear"},
    "TINY_VIT": {"conv", "layout", "pointwise", "norm", "linear", "attn"},
    "swin_tiny": {"conv", "layout", "pointwise", "norm", "linear", "attn"},
    "convnext_tiny": {"conv", "layout", "pointwise", "norm", "linear"},
    "maxvit_tv": {"conv", "layout", "pointwise", "norm", "linear", "attn"},
    "maxvit_paper": {"conv", "layout", "pointwise", "norm", "linear",
                     "attn"}}


@pytest.fixture(scope="module")
def models():
    return {name: make().eval().requires_grad_(False)
            for name, (make, _) in MODELS.items()}


@pytest.fixture(autouse=True)
def no_records():
    trace.clear()
    yield
    trace.clear()


def _images(n=2, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (n, 3, HW, HW), dtype=np.float32))


def _profiled(fn):
    """``fn()`` under a CPU profiler, inside the span ``call``: (its
    result, the span, the part spans), from a cleared store."""
    trace.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        with trace.span("call"):
            out = fn()
    (call,) = [s for s in trace.records() if s.name == "call"]
    return out, call, trace.records(parts=True)


def _leaves(parts):
    """Whether no two parts of one thread overlap."""
    by_thread = {}
    for s in parts:
        by_thread.setdefault(s.thread, []).append(s)
    return all(a.end_ns <= b.start_ns for spans in by_thread.values()
               for a, b in zip(spans, spans[1:]))


def test_nothing_recorded_without_a_profiler(models):
    """No profiler: a part is the shared no-op context, and a forward and
    a gradient record nothing."""
    x = _images()
    assert trace.part("linear", x) is trace.span("a")
    with torch.no_grad():
        models["convnext_tiny"](x)
    ModelBundle(ModelMeta(name="r", family="cnn", img_hw=HW),
                models["TINY_R"]).score_and_grad(x, 3)
    assert trace.records(parts=True) == [] and trace.records() == []


@pytest.mark.parametrize("name", list(MODELS))
def test_a_forward_records_its_parts_as_leaves(models, name):
    m = models[name]
    x = _images()
    with torch.no_grad():
        _, call, parts = _profiled(lambda: m(x))
    assert {s.name for s in parts} <= KINDS
    assert {s.name.split(".", 1)[1] for s in parts} == FORWARD_KINDS[name]
    assert len(parts) == MODELS[name][1](m)
    assert _leaves(parts)
    for s in parts:
        assert s.parent == call.id
        assert call.start_ns <= s.start_ns <= s.end_ns <= call.end_ns
        assert s.device_s is None and s.card == "cpu"
        assert s.counted("model_rows") == 0
    # the layer spans are apart from the parts
    assert [s.name for s in trace.records()] == ["call"]


# operators that make no device work: views and their strides
VIEWS = {"aten::as_strided", "aten::permute", "aten::select", "aten::slice",
         "aten::view", "aten::transpose", "aten::expand", "aten::unsqueeze",
         "aten::t", "aten::detach", "aten::alias"}


@pytest.mark.parametrize("grad", [False, True], ids=["no_grad", "graph"])
@pytest.mark.parametrize("name", list(MODELS) + ["TINY_VIT_taps"])
def test_tiled_forwards_run_every_operator_in_a_part(models, name, grad):
    """Each part of a tiled forward on a card starts where the one before
    ended (``trace.tiled``), so between a forward's first part and its last
    every operator that is not a view runs inside a part."""
    taps = name.endswith("_taps")
    m = models[name.removesuffix("_taps")]
    x = _images().requires_grad_(grad)
    trace.clear()
    with torch.set_grad_enabled(grad):
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            m(x, taps=True) if taps else m(x)
    parts = trace.records(parts=True)
    lo, hi = parts[0].start_ns, parts[-1].end_ns
    outside = set()
    for e in prof.profiler.kineto_results.events():
        a, b = e.start_ns(), e.start_ns() + e.duration_ns()
        if (e.name().startswith("aten::") and e.name() not in VIEWS
                and lo <= a and b <= hi
                and not any(s.start_ns <= a and b <= s.end_ns
                            for s in parts)):
            outside.add(e.name())
    assert not outside


def test_convnext_parts_by_kind(models):
    """convnext_tiny (3-3-9-3): six parts a block, three in the stem, two a
    downsampling, three in the head."""
    with torch.no_grad():
        _, _, parts = _profiled(lambda: models["convnext_tiny"](_images()))
    kinds = [s.name.split(".", 1)[1] for s in parts]
    blocks = 18
    assert {k: kinds.count(k) for k in set(kinds)} == {
        "layout": 1, "conv": 1 + blocks + 3, "norm": 1 + blocks + 3 + 1,
        "linear": 2 * blocks + 1, "pointwise": 2 * blocks + 1}


@pytest.mark.parametrize("name", ["TINY_R", "convnext_tiny", "maxvit_tv"])
def test_backward_is_one_part_a_gradient_call(models, name):
    bundle = ModelBundle(ModelMeta(name=name, family="cnn", img_hw=HW),
                         models[name])
    x = _images(3)
    (g, _), call, parts = _profiled(lambda: bundle.score_and_grad(x, 5))
    backward = [s for s in parts if s.name == "part.backward"]
    assert len(backward) == 1 and backward[0].parent == call.id
    assert len(parts) == MODELS[name][1](models[name]) + 1
    assert parts[-1].name == "part.backward"
    assert _leaves(parts)
    assert g.shape == x.shape


def test_a_part_inside_a_part_records_nothing():
    """Parts are leaves: an inner one is timed by the outer one."""
    x = _images(1)
    with profile(activities=[ProfilerActivity.CPU]):
        with trace.part("norm", x):
            with trace.part("pointwise", x):
                y = x * 2
    (only,) = trace.records(parts=True)
    assert only.name == "part.norm" and only.parent is None
    assert torch.equal(y, x * 2)


@pytest.mark.parametrize("name", list(MODELS))
def test_logits_are_bit_identical_with_the_profiler(models, name):
    m = models[name]
    x = _images(2, seed=1)
    with torch.no_grad():
        off = m(x)
        on, _, parts = _profiled(lambda: m(x))
    assert parts and torch.equal(on, off)


def test_maps_and_battery_scores_are_bit_identical_with_the_profiler(
        models):
    """TINY_R's input gradient (the IG sweep's call) and an image-by-image
    battery, with and without the profiler."""
    bundle = ModelBundle(ModelMeta(name="TINY_R", family="cnn", img_hw=HW),
                         models["TINY_R"])
    x = _images(3, seed=2)
    g_off, s_off = bundle.score_and_grad(x, 7)
    (g_on, s_on), _, parts = _profiled(
        lambda: bundle.score_and_grad(x, 7))
    assert parts and torch.equal(g_on, g_off) and torch.equal(s_on, s_off)

    img = x[0].permute(1, 2, 0).contiguous()
    sal = np.random.default_rng(4).random((HW, HW), np.float32)

    def battery():
        return run_battery(bundle.apply, img, sal, common.default_blur(),
                           chunk=45, target=7)
    off = battery()
    on, _, parts = _profiled(battery)
    assert parts and on == off


@pytest.fixture
def card():
    """The first CUDA card, or a skip."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.card
@pytest.mark.parametrize("name", list(MODELS))
@pytest.mark.parametrize("grad", [False, True], ids=["no_grad", "ig"])
def test_card_parts_time_the_device(models, card, name, grad):
    """Every part of a forward on the card (and the IG sweep's backward)
    has a positive ``device_s``, and their sum is at most the device time
    between two events around the whole call (each event's clock reads
    to about half a microsecond)."""
    bundle = ModelBundle(ModelMeta(name=name, family="cnn", img_hw=HW),
                         models[name]).to(card)
    x = _images(4).to(card)

    def call():
        if grad:
            return bundle.score_and_grad(x, 5)
        with torch.no_grad():
            return bundle.apply(x)
    call()
    torch.cuda.synchronize(card)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    _, _, parts = _profiled(call)
    end.record()
    end.synchronize()
    whole = start.elapsed_time(end) / 1e3
    expected = MODELS[name][1](models[name]) + grad
    if name == "swin_tiny" and not grad:
        expected += 1              # the patch norm's input copy
    assert len(parts) == expected
    assert all(s.device_s is not None and s.device_s > 0 for s in parts)
    assert all(s.card == str(card) for s in parts)
    assert sum(s.device_s for s in parts) <= whole + 1e-6
    assert _leaves(parts)


@pytest.mark.card
def test_card_parts_hold_few_events(models, card, monkeypatch):
    """With room for 16 unread parts, a forward of 120 parts reads the
    oldest as it goes and reuses their events: no more than one batch is
    made."""
    monkeypatch.setattr(trace, "_PENDING_MAX", 16)
    m = copy.deepcopy(models["convnext_tiny"]).to(card)
    x = _images(4).to(card)
    before = trace.counters().get("part_events", 0)
    trace.clear()
    with torch.no_grad(), profile(activities=[ProfilerActivity.CUDA]):
        m(x)
        assert len(trace._PENDING) <= 16
    parts = trace.records(parts=True)
    assert len(parts) == _convnext_parts(m)
    assert trace.counters().get("part_events", 0) - before <= trace._MAKE
    assert all(s.device_s > 0 for s in parts)
