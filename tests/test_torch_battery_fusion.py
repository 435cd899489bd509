"""The battery's three reveal passes as one batch (``metrics/curves.py
_battery``) against the three separate ``batched_curves`` passes it
replaced, composed here, on the CPU: a 64 px TINY_R (65 curve points,
chunk 45 ragged, 13 dividing) and a 32 px two-block ViT (33 points, chunk
45 one ragged chunk, 11 dividing), at B=1, 2 and 3 (three passes, two
and one a forward at chunk 45: ``passes_per_forward``), targets given and
from the argmax, with the 10 scores of ``run_battery`` and
``battery_scores``; and the ``battery_forwards`` counter, one a chunk
for all three passes while they fit in ``FUSED_ROWS``.  The batched
battery over a two-shard mesh, and on the ViT, is held against the
per-image battery in ``test_torch_curves.py``."""
import math

import numpy as np
import pytest
import torch

from xai_tpu_torch.metrics import curves as TC
from xai_tpu_torch.models import vit as tvit
from xai_tpu_torch.models.common import ModelBundle, ModelMeta
from xai_tpu_torch.runners.common import build_bundle, default_blur
from xai_tpu_torch.utils import trace

from torch_one_thread import one_torch_thread  # noqa: F401 (autouse)

# model name -> (image side, its chunks: 45, then one dividing the points)
MODELS = {"tiny_r": (64, 13), "vit": (32, 11)}


@pytest.fixture(scope="module")
def bundles():
    vit = ModelBundle(
        ModelMeta(name="v", family="vit", img_hw=32, num_classes=16),
        tvit.init_random(tvit.VisionTransformer(tvit.ViTConfig(
            patch=8, embed_dim=32, depth=2, num_heads=4, mlp_ratio=2.0,
            num_classes=16, img_hw=32)), seed=4))
    return {"tiny_r": build_bundle("TINY_R", seed=3, device="cpu"),
            "vit": vit}


def _inputs(hw, b, seed=0):
    """``[B, H, W, C]`` images, ``[B, H, W]`` saliencies, and the flip
    steps as the battery makes them."""
    rs = np.random.RandomState(seed)
    images = rs.randn(b, hw, hw, 3).astype(np.float32)
    sals = rs.rand(b, hw, hw).astype(np.float32)
    desc, asc = TC.flip_schedules(sals, hw)
    return images, sals, desc, asc


def _nchw(images):
    return torch.from_numpy(images.transpose(0, 3, 1, 2).copy())


@torch.inference_mode()
def _unfused(apply_fn, blur_fn, x, desc, asc, n_steps, chunk, targets):
    """The three passes as three ``batched_curves`` calls of ``B`` images
    each."""
    if targets is None:
        targets = apply_fn(x).argmax(dim=-1)
    blurred, zeros = blur_fn(x), torch.zeros_like(x)
    return (TC.batched_curves(apply_fn, blurred, x, desc, targets, n_steps,
                              chunk),
            TC.batched_curves(apply_fn, x, zeros, desc, targets, n_steps,
                              chunk),
            TC.batched_curves(apply_fn, x, zeros, asc, targets, n_steps,
                              chunk), targets)


def _five(ins, dele, lerf):
    return torch.stack([ins[0], ins[1], dele[0], dele[1], lerf[0]])


def _assert_curves_close(got, want):
    """Target probabilities and top-1 within 1e-6; entropies, in bits near
    log2 of the class count, within 1e-6 of their size (a batch of
    another row count rounds a CPU convolution's sums in another order,
    an ulp or two)."""
    tp, top1, ent = (g.numpy() for g in got)
    np.testing.assert_allclose(tp, want[0].numpy(), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(top1, want[1].numpy())
    np.testing.assert_allclose(ent, want[2].numpy(), rtol=1e-6, atol=0)


def _unfused_scores(bundle, images, sals, chunk, targets):
    b, hw = images.shape[:2]
    desc, asc = TC.flip_schedules(sals, hw)
    x = _nchw(images)
    ins, dele, lerf, _ = _unfused(
        bundle.apply, default_blur(), x,
        torch.from_numpy(desc.reshape(b, hw, hw)),
        torch.from_numpy(asc.reshape(b, hw, hw)), hw, chunk,
        torch.tensor(targets))
    return TC.assemble_scores(_five(ins, dele, lerf).numpy(), sals, desc,
                              hw)


def _assert_scores_close(got, want):
    """Within 1e-5, the tolerance of the batched battery against the
    per-image one (``test_torch_curves.py``): MAS divides by the gap
    between the original's and the baseline's probability, which
    magnifies the curves' last-ulp differences."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert list(g) == list(w)
        for k in w:
            assert g[k] == pytest.approx(w[k], abs=1e-5, nan_ok=True), k


def _cases():
    for model, (hw, divisor) in MODELS.items():
        for b in (1, 2, 3):
            # B=2 for its two-pass forwards at chunk 45 alone
            for chunk in (45,) if b == 2 else (45, divisor):
                for given in (True, False):
                    yield pytest.param(
                        model, b, chunk, given,
                        id=f"{model}-b{b}-chunk{chunk}-"
                           f"{'given' if given else 'argmax'}")


@pytest.mark.parametrize("model, b, chunk, given", _cases())
def test_fused_battery_equals_three_passes(bundles, model, b, chunk, given):
    """Every curve of the fused ``_battery`` (and, with targets given,
    the five of ``battery_curves`` and the 10 scores of ``run_battery``
    at B=1, else ``battery_scores``) equals the separate passes': each
    row is the same revealed image read at the same target."""
    bundle = bundles[model]
    hw = MODELS[model][0]
    images, sals, desc, asc = _inputs(hw, b)
    x = _nchw(images)
    desc_t = torch.from_numpy(desc.reshape(b, hw, hw))
    asc_t = torch.from_numpy(asc.reshape(b, hw, hw))
    targets = torch.tensor([3, 0, 7][:b]) if given else None
    blur = default_blur()
    want = _unfused(bundle.apply, blur, x, desc_t, asc_t, hw, chunk,
                    targets)
    got = TC._battery(bundle.apply, blur, x, desc_t, asc_t, hw, chunk,
                      targets)
    assert torch.equal(got[3], want[3])
    for got_pass, want_pass in zip(got[:3], want[:3]):
        assert [g.shape for g in got_pass] == [(b, hw + 1)] * 3
        _assert_curves_close(got_pass, want_pass)
    if not given:
        return
    curves = TC.battery_curves(bundle.apply, blur, x, desc_t, asc_t, hw,
                               chunk, targets)
    assert curves.shape == (5, b, hw + 1)
    np.testing.assert_allclose(curves.numpy(), _five(*want[:3]).numpy(),
                               rtol=0, atol=1e-6)
    if b == 1:
        scores = [TC.run_battery(bundle.apply, torch.from_numpy(images[0]),
                                 sals[0], blur, chunk=chunk,
                                 target=int(targets[0]))]
    else:
        scores = TC.battery_scores(bundle.apply, torch.from_numpy(images),
                                   sals, blur, chunk=chunk,
                                   targets=targets.tolist())
    assert all(len(s) == 10 for s in scores)
    _assert_scores_close(scores, _unfused_scores(
        bundle, images, sals, chunk, targets.tolist()))


@pytest.mark.parametrize("model", list(MODELS))
@pytest.mark.parametrize("chunk", [45, "divisor"])
@pytest.mark.parametrize("b", [1, 2, 3])
def test_battery_forwards_one_a_chunk(bundles, model, chunk, b):
    """``battery_forwards`` grows by ceil((n_steps + 1) / chunk) a battery
    call while a chunk's three passes fit in ``FUSED_ROWS`` (every case
    but B=2 and B=3 at chunk 45: 90 and 135 rows a pass), and by that
    times the forwards a chunk's passes need beyond it; each forward is
    whole passes, and the rows are the three passes'."""
    bundle = bundles[model]
    hw, divisor = MODELS[model]
    chunk = divisor if chunk == "divisor" else chunk
    images, sals, _, _ = _inputs(hw, b)
    shapes = []

    def apply_fn(imgs):
        shapes.append(imgs.shape[0])
        return bundle.apply(imgs)

    before = trace.counters().get("battery_forwards", 0)
    rows = trace.counters().get("model_rows", 0)
    TC.battery_scores(apply_fn, torch.from_numpy(images), sals,
                      default_blur(), chunk=chunk, targets=[1] * b)
    after = trace.counters()
    group = TC.passes_per_forward(b, chunk)
    assert group == (3 if 3 * b * chunk <= TC.FUSED_ROWS else
                     {90: 2, 135: 1}[b * chunk])
    chunks = math.ceil((hw + 1) / chunk)
    assert after["battery_forwards"] - before == chunks * math.ceil(
        3 / group) == len(shapes)
    # whole passes a forward: the first a chunk holds group x B x chunk
    assert shapes[0] == group * b * min(chunk, hw + 1)
    # the same rows as three passes: 3 x B x (n_steps + 1)
    assert after["model_rows"] - rows == 3 * b * (hw + 1) == sum(shapes)


def test_battery_forwards_five_at_224_px():
    """At 224 px a battery is 225 points in chunks of 45: 5 forwards of
    3 x 45 rows (three passes apart: 15 of 45).  A linear read of the
    channel means stands in for a model."""
    head = torch.randn(3, 10, generator=torch.Generator().manual_seed(0))
    shapes = []

    def apply_fn(imgs):
        shapes.append(tuple(imgs.shape))
        return imgs.mean(dim=(2, 3)) @ head

    rs = np.random.RandomState(2)
    before = trace.counters().get("battery_forwards", 0)
    scores = TC.run_battery(
        apply_fn, torch.from_numpy(rs.randn(224, 224, 3).astype(np.float32)),
        rs.rand(224, 224).astype(np.float32), lambda x: x * 0.5, chunk=45,
        target=4)
    assert trace.counters()["battery_forwards"] - before == 5
    assert shapes == [(3 * 45, 3, 224, 224)] * 5
    assert len(scores) == 10
