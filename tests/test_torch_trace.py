"""The port's spans and counters (``xai_tpu_torch/utils/trace.py``) on the
CPU, on TINY_R at 64 px: nothing recorded without a profiler; the
battery's spans nested and linked under ``profile(activities=[CPU])``;
the mesh battery's per-shard spans from its pool threads; the profiler's
own events inside the program's spans (one clock); ``model_rows`` of one
image-by-image step and of the methods that run the module themselves;
the kernel wrappers' launch counters."""
import sys
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from xai_tpu_torch.kernels import blur as kblur
from xai_tpu_torch.kernels import quickshift as kq
from xai_tpu_torch.kernels import reveal as kreveal
from xai_tpu_torch.methods import clip_explain, clip_m2ib, clip_surgery
from xai_tpu_torch.methods import vit_explain
from xai_tpu_torch.metrics.curves import run_battery
from xai_tpu_torch.models import clip as tclip
from xai_tpu_torch.models import vit as tvit
from xai_tpu_torch.models.common import ModelBundle, ModelMeta
from xai_tpu_torch.parallel.mesh import make_mesh
from xai_tpu_torch.parallel.sharded_battery import sharded_battery_scores
from xai_tpu_torch.runners import common
from xai_tpu_torch.runners import evaluate_perturbation as ep
from xai_tpu_torch.utils import trace

from torch_one_thread import one_torch_thread  # noqa: F401 (autouse)

HW = 64
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def bundle():
    return common.build_bundle("TINY_R", seed=3, device="cpu")


@pytest.fixture(autouse=True)
def no_records():
    trace.clear()
    yield
    trace.clear()


def _kept(bundle, i):
    img = np.random.default_rng(i).random((HW, HW, 3), dtype=np.float32)
    x = common.normalize_input(img, "cnn", CPU)
    target, pred, _ = common.image_gates(bundle, x, common.default_blur(),
                                         gates=False)
    return {"x": x, "trans_img": img, "target": target,
            "original_pred": pred, "name": f"img{i}",
            "generator": common.image_generator(0, i, CPU)}


def _saliency(i):
    return np.random.default_rng(100 + i).random((HW, HW), np.float32)


def _inside(child, parent):
    return (parent.start_ns <= child.start_ns <= child.end_ns
            <= parent.end_ns)


def test_nothing_recorded_without_a_profiler(bundle, tmp_path):
    """No profiler: a driver run records no span, and a span is the one
    shared no-op context."""
    assert trace.span("a") is trace.span("b", card="cuda:0")
    ep.main(["--model", "TINY_R", "--synthetic", "1", "--image_count", "1",
             "--output_dir", str(tmp_path)], device="cpu")
    assert trace.records() == []


def test_run_battery_spans_nest(bundle):
    p = _kept(bundle, 0)
    with profile(activities=[ProfilerActivity.CPU]):
        run_battery(bundle.apply, p["x"], _saliency(0),
                    common.default_blur(), chunk=45, target=p["target"])
    spans = trace.records()
    assert [s.name for s in spans] == ["battery", "battery.schedule",
                                       "battery.shard", "battery.read",
                                       "battery.score"]
    battery = spans[0]
    assert battery.parent is None
    for child in spans[1:]:
        assert child.parent == battery.id and _inside(child, battery)
        assert child.thread == battery.thread
    # the battery's forwards: 3 passes of 65 rows, no target forward
    assert battery.counted("model_rows") == 3 * (HW + 1)


def test_sharded_battery_records_a_span_a_shard(bundle):
    """Two shards on a virtual mesh of the CPU device twice: a
    ``battery.shard`` span each, from a pool thread, under ``battery``."""
    pend = [_kept(bundle, i) for i in range(2)]
    mesh = make_mesh(devices=[CPU, CPU])
    with profile(activities=[ProfilerActivity.CPU]):
        sharded_battery_scores(
            bundle, torch.stack([p["x"] for p in pend]),
            np.stack([_saliency(i) for i in range(2)]),
            common.default_blur(), chunk=45,
            targets=[p["target"] for p in pend], mesh=mesh)
    spans = trace.records()
    (battery,) = [s for s in spans if s.name == "battery"]
    shards = [s for s in spans if s.name == "battery.shard"]
    assert len(shards) == 2
    for s in shards:
        assert s.parent == battery.id and _inside(s, battery)
        assert s.card == "cpu"
        assert s.thread != battery.thread
    assert shards[0].thread != shards[1].thread
    assert {s.name for s in spans if s.parent == battery.id} == {
        "battery.schedule", "battery.shard", "battery.read", "battery.score"}


def test_profiler_events_fall_inside_the_programs_span(bundle):
    """The profiler's ``aten::`` events of ``image_gates`` lie inside the
    program's ``image_gates`` span: the spans are on the profiler's
    clock."""
    x = _kept(bundle, 1)["x"]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        common.image_gates(bundle, x, common.default_blur(), gates=False)
    (gates,) = trace.records()
    events = [e for e in prof.profiler.kineto_results.events()
              if e.name().startswith("aten::")]
    assert any(e.name() == "aten::conv2d" for e in events)
    for e in events:
        assert gates.start_ns <= e.start_ns()
        assert e.start_ns() + e.duration_ns() <= gates.end_ns
    annotation = [e for e in prof.profiler.kineto_results.events()
                  if e.name() == "image_gates"]
    assert len(annotation) == 1


def test_model_rows_of_one_image_by_image_step(bundle):
    """One in ``image_gates(gates=False)``, IG-50's 50, and 3 x 65 in a
    battery with its target given."""
    before = trace.counters().get("model_rows", 0)
    p = _kept(bundle, 2)
    assert trace.counters()["model_rows"] - before == 1
    with profile(activities=[ProfilerActivity.CPU]):
        sals, scores, _ = ep.kept_step(bundle, "cnn", [p],
                                       common.default_blur(), "ig")
    assert trace.counters()["model_rows"] - before == 1 + 50 + 3 * (HW + 1)
    step, = [s for s in trace.records() if s.name == "step"]
    assert step.counted("model_rows") == 50 + 3 * (HW + 1)
    attribution, = [s for s in trace.records() if s.name == "attribution"]
    assert attribution.parent == step.id
    assert attribution.counted("model_rows") == 50
    assert sals.shape == (1, HW, HW) and len(scores) == 1


@pytest.fixture(scope="module")
def small_models():
    """A 32 px two-block ViT and CLIP, seeded random weights."""
    vit = ModelBundle(
        ModelMeta(name="v", family="vit", img_hw=32, num_classes=16),
        tvit.init_random(tvit.VisionTransformer(tvit.ViTConfig(
            patch=8, embed_dim=32, depth=2, num_heads=4, mlp_ratio=2.0,
            num_classes=16, img_hw=32))))
    cfg = tclip.CLIPConfig(patch=8, vision_width=32, vision_layers=2,
                           vision_heads=4, embed_dim=16, text_width=16,
                           text_heads=2, text_layers=2, vocab_size=50,
                           context_length=12, img_hw=32)
    te = torch.nn.functional.normalize(
        torch.randn(10, 16, generator=torch.Generator().manual_seed(3)),
        dim=-1)
    clip = tclip.CLIPBundle(
        ModelMeta(name="c", family="clip", img_hw=32, num_classes=10),
        tclip.init_random(tclip.CLIP(cfg)), te)
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (2, 32, 32, 3), dtype=np.float32))
    tokens = torch.from_numpy(np.random.default_rng(6).integers(
        1, 50, (2, 12)))
    return {"vit": vit, "clip": clip, "x": x, "tokens": tokens}


# methods that run the module themselves, from their input: (call, the
# rows they send through it for two images)
OWN_FORWARDS = {
    "vit_explain.attn_ig": (lambda m: vit_explain.attn_ig(
        m["vit"], m["x"], [3, 0], steps=5), 2 * 5),
    "clip_explain.encode_dense": (lambda m: clip_explain.encode_dense(
        m["clip"], m["x"]), 2),
    "clip_explain.mm_grads": (lambda m: clip_explain.mm_grads(
        m["clip"], m["x"], m["tokens"]), 2),
    "clip_surgery.surgery_encode": (lambda m: clip_surgery.surgery_encode(
        m["clip"], m["x"]), 2),
    "clip_m2ib.visual_prefix": (lambda m: clip_m2ib.visual_prefix(
        m["clip"], m["x"].permute(0, 3, 1, 2), 0), 2),
}


@pytest.mark.parametrize("method", list(OWN_FORWARDS))
def test_model_rows_of_a_methods_own_forwards(small_models, method):
    """A method that runs the module itself counts its rows as a bundle
    entry does."""
    call, rows = OWN_FORWARDS[method]
    before = trace.counters().get("model_rows", 0)
    call(small_models)
    assert trace.counters().get("model_rows", 0) - before == rows


@pytest.mark.parametrize("wrapper", [kblur.blur_planes,
                                     kreveal.reveal_batch,
                                     kq.quickshift_parents],
                         ids=lambda w: w.__name__)
def test_launch_counters_count_from_many_threads(wrapper, monkeypatch):
    """``count_launches`` adds to the wrapper's ``.launches`` (which
    callers reset), losing no update across threads."""
    monkeypatch.setattr(wrapper, "launches", 0)
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [
            trace.count_launches(wrapper, 2) for _ in range(500)])
            for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in threads)
    assert wrapper.launches == 8 * 500 * 2
