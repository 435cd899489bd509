"""The library metrics of xai_tpu_torch (ROADMAP A12 slice 2) against
xai_tpu's, on the CPU: ``reveal_curves`` and ``patch_flip_steps``, the
native ``slic`` and ``project_curve``, the reference-shaped classic
metric classes (MAS, RISE, AIC, MoRF/LeRF, Monotonicity and the ViT
embedding capture), PIC (SIC/AIC) and the confusion-matrix IoU.

The model is xai_tpu's 32 px test ViT carried through ``.npz``; raw
curves must be within 1e-6 of xai_tpu's, the metrics' normalized curves
within 1e-5 (a min-max stretches the curves' rounding), flip steps,
labels and projections exactly equal.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xai_tpu import native as JN
from xai_tpu.metrics import classic as JK
from xai_tpu.metrics import confusion as JCF
from xai_tpu.metrics import curves as JCV
from xai_tpu.metrics import pic as JP
from xai_tpu.ops.blur import make_blur_fn as jax_blur

from xai_tpu_torch import native as TN
from xai_tpu_torch.kernels.reveal import reveal_batch
from xai_tpu_torch.metrics import classic as TK
from xai_tpu_torch.metrics import confusion as TCF
from xai_tpu_torch.metrics import curves as TCV
from xai_tpu_torch.metrics import pic as TP
from xai_tpu_torch.ops.blur import make_blur_fn

from test_torch_vit import tiny_vit_twins
from torch_one_thread import one_torch_thread  # noqa: F401 (autouse)

HW = 32


@pytest.fixture(scope="module")
def twins(tmp_path_factory):
    jb, tb = tiny_vit_twins(str(tmp_path_factory.mktemp("p") / "vit.npz"))
    rs = np.random.RandomState(2)
    x = rs.randn(HW, HW, 3).astype(np.float32)
    sal = rs.rand(HW, HW).astype(np.float32)
    return jb, tb, x, sal


def _grid(n=4):
    side = HW // n
    return (np.arange(HW)[:, None] // side * n
            + np.arange(HW)[None, :] // side).astype(np.int32)


def test_patch_flip_steps_is_xai_tpus():
    rs = np.random.RandomState(0)
    sal = rs.randint(0, 3, size=(HW, HW)).astype(np.float32)   # ties
    for desc in (True, False):
        got = TCV.patch_flip_steps(sal, _grid(), desc)
        assert np.array_equal(got, JCV.patch_flip_steps(sal, _grid(), desc))
        # one segment a step: the step count is the number of segments
        assert sorted(set(got.tolist())) == list(range(1, 17))


@pytest.mark.parametrize("mode", ["start", "finish", "neither", "inferred"])
def test_reveal_curves_matches_xai_tpu(twins, mode, monkeypatch):
    """Every ``original_at`` mode: read off the start or the finish, one
    extra forward of an original that is neither endpoint, and the
    endpoint inferred by exact equality.  Each chunk is one reveal launch
    (the batch of one of batched_curves)."""
    jb, tb, x, sal = twins
    blurred = np.asarray(jax_blur(31, 31.0)(jnp.asarray(x)[None])[0])
    flip = JCV.pixel_flip_steps(sal, HW)
    start, finish = (x, np.zeros_like(x)) if mode != "finish" else \
        (blurred, x)
    kw = {"start": dict(original_at="start"),
          "finish": dict(original_at="finish"),
          "neither": dict(original_img=x * 0.5),
          "inferred": dict(original_img=x)}[mode]
    ref = JCV.reveal_curves(jb.apply, jb.params, start, finish, flip, HW, 3,
                            chunk=10, **kw)
    calls = []
    monkeypatch.setattr(TCV, "reveal_batch", lambda *a: (
        calls.append(None), reveal_batch(*a))[1])
    tkw = {k: torch.from_numpy(v) if k == "original_img" else v
           for k, v in kw.items()}
    got = TCV.reveal_curves(tb.apply, torch.from_numpy(start),
                            torch.from_numpy(finish), flip, HW, 3, chunk=10,
                            **tkw)
    assert len(calls) == 4                       # 33 points in chunks of 10
    for f in ("target_prob", "top1_is_target", "entropy"):
        np.testing.assert_allclose(getattr(got, f), getattr(ref, f),
                                   atol=1e-6, err_msg=f)
    for f in ("original_pred", "baseline_pred", "baseline_top1"):
        assert abs(getattr(got, f) - getattr(ref, f)) < 1e-6, f


def test_reveal_curves_needs_an_endpoint(twins):
    _, tb, x, sal = twins
    t = torch.from_numpy(x)
    with pytest.raises(ValueError, match="original_at"):
        TCV.reveal_curves(tb.apply, t, t * 0, TCV.pixel_flip_steps(sal, HW),
                          HW, 3)


def test_slic_labels_are_xai_tpus():
    for seed, n in ((0, 16), (1, 49), (2, 196)):
        img = np.random.RandomState(seed).rand(48, 40, 3).astype(np.float32)
        for compactness in (10.0, 10000.0):
            got = TN.slic(img, n, compactness)
            assert got.dtype == np.int32
            assert np.array_equal(got, JN.slic(img, n, compactness))


@pytest.mark.parametrize("mode", ["del", "ins"])
def test_project_curve_is_xai_tpus(mode):
    rs = np.random.RandomState(3)
    for n in (5, 33, 197):
        y = np.sort(rs.rand(n))
        y = y[::-1].copy() if mode == "del" else y
        y += 0.05 * rs.randn(n)
        assert np.array_equal(TN.project_curve(y, mode),
                              JN.project_curve(y, mode))


def _pair(cls_name, jb, tb, mode, step=HW):
    return (getattr(JK, cls_name)(jb, HW * HW, mode, step,
                                  jax_blur(31, 31.0)),
            getattr(TK, cls_name)(tb, HW * HW, mode, step,
                                  make_blur_fn(31, 31.0)))


def _same(got, ref, tol=1e-5):
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(np.asarray(g, np.float64),
                                   np.asarray(r, np.float64), atol=tol)


@pytest.mark.parametrize("cls_name,mode", [
    ("MASMetric", "ins"), ("MASMetric", "del"), ("MASMetric", "lerf"),
    ("RISEMetric", "ins"), ("RISEMetric", "del"),
    ("AICMetric", "ins"), ("AICMetric", "del"),
    ("PositiveNegativePerturbation", "morf"),
    ("PositiveNegativePerturbation", "lerf"),
    ("MonotonicityMetric", "positive"), ("MonotonicityMetric", "negative")])
def test_classic_metrics_match(twins, cls_name, mode):
    """Pixel-ranked, and patch-ranked on a 4 x 4 grid."""
    jb, tb, x, sal = twins
    jm, tm = _pair(cls_name, jb, tb, mode)
    _same(tm.single_run(torch.from_numpy(x), sal),
          jm.single_run(x, sal))
    _same(tm.single_run(torch.from_numpy(x), sal, patch_mask=_grid()),
          jm.single_run(x, sal, patch_mask=_grid()))


def test_mas_special_version_and_aic_decision_flip_match(twins):
    jb, tb, x, sal = twins
    jm, tm = _pair("MASMetric", jb, tb, "del")
    _same(tm.single_run(torch.from_numpy(x), sal, special_version=True),
          jm.single_run(x, sal, special_version=True))
    for mode in ("ins", "del"):
        jm, tm = _pair("AICMetric", jb, tb, mode)
        _same(tm.single_run(torch.from_numpy(x), sal, decision_flip=True),
              jm.single_run(x, sal, decision_flip=True))


def test_embeddings_sweep_matches(twins):
    """Every block's token embeddings at every reveal step (the ViT taps),
    the predicted classes and the response."""
    jb, tb, x, sal = twins
    jm, tm = _pair("MASMetric", jb, tb, "del")
    ref = jm.single_run_embeddings(x, sal, max_batch_size=8)
    got = tm.single_run_embeddings(torch.from_numpy(x), sal,
                                   max_batch_size=8)
    assert got[0].shape == ref[0].shape == (2, HW + 1, 17, 32)
    np.testing.assert_allclose(got[0], ref[0], atol=1e-5)
    assert np.array_equal(got[1], ref[1])
    np.testing.assert_allclose(got[2], ref[2], atol=1e-6)
    assert np.array_equal(got[3], ref[3])


def _pic_inputs():
    rs = np.random.RandomState(4)
    img = rs.rand(HW, HW, 3).astype(np.float32)
    sal = rs.rand(HW, HW).astype(np.float32)
    mask = JP.generate_random_mask(HW, HW, 0.05, rng=np.random.RandomState(5))
    return img, sal, mask


def test_pic_matches_with_the_same_random_mask(twins):
    """SIC and AIC (one threshold sweep) and the single-metric form, with
    the same random mask and PIL's lossless WebP entropy, normalized as
    the ViT's input."""
    jb, tb, _, _ = twins
    img, sal, mask = _pic_inputs()
    ref = JP.compute_both_metrics(jb, img, sal, mask,
                                  normalize_fn=lambda v: (v - 0.5) / 0.5)
    got = TP.compute_both_metrics(tb, img, sal, mask,
                                  normalize_fn=lambda v: (v - 0.5) / 0.5)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.curve_y, r.curve_y, atol=1e-5)
        assert abs(g.auc - r.auc) < 1e-5
    for method in (0, 1):
        r = JP.compute_pic_metric(jb, img, sal, mask, method=method,
                                  normalize_fn=lambda v: (v - 0.5) / 0.5)
        g = TP.compute_pic_metric(tb, img, sal, mask, method=method,
                                  normalize_fn=lambda v: (v - 0.5) / 0.5)
        if isinstance(r, int):
            assert g == r
        else:
            assert abs(g.auc - r.auc) < 1e-5
    agg = TP.aggregate_individual_pic_results(list(got), "mean")
    ref_agg = JP.aggregate_individual_pic_results(list(ref), "mean")
    assert abs(agg.auc - ref_agg.auc) < 1e-5


def test_pic_helpers_are_xai_tpus():
    img, _, mask = _pic_inputs()
    assert np.array_equal(TP.create_blurred_image(img, mask),
                          JP.create_blurred_image(img, mask))
    u8 = (img * 255).astype(np.uint8)
    assert TP.estimate_image_entropy(u8) == JP.estimate_image_entropy(u8)


def test_confusion_and_iou_match():
    rs = np.random.RandomState(6)
    for normalized, ignore in ((False, None), (True, 0), (False, (1, 2))):
        tm, jm = TCF.IoU(4, normalized, ignore), JCF.IoU(4, normalized,
                                                         ignore)
        for _ in range(3):
            pred, tgt = rs.randint(-1, 5, (2, 50))
            tm.add(pred, tgt)
            jm.add(pred, tgt)
        (ti, tmean), (ji, jmean) = tm.value(), jm.value()
        np.testing.assert_array_equal(ti, ji)
        assert tmean == jmean or (np.isnan(tmean) and np.isnan(jmean))
        np.testing.assert_array_equal(tm.conf_metric.value(),
                                      jm.conf_metric.value())
