"""The tools around the drivers, xai_tpu_torch against xai_tpu on the CPU:
``--save_maps``, the image finder, the qualitative panels, the rendering
helpers, the sweep, and the blur at MDA's wider kernels.
"""
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xai_tpu.kernels.blur_pallas import _factors as jax_factors
from xai_tpu.kernels.blur_pallas import pallas_blur
from xai_tpu.ops.blur import gaussian_blur as jax_gaussian_blur
from xai_tpu.runners import evaluate_perturbation as JP
from xai_tpu.runners import image_finder as JF
from xai_tpu.runners import sweep as JW
from xai_tpu.runners.common import build_bundle as jax_build_bundle
from xai_tpu.runners.common import save_params
from xai_tpu.utils import render as JR
from xai_tpu.utils import saver as JS
from xai_tpu.utils import visualization as JV

from xai_tpu_torch.data.imagenet import ImageNetValStream
from xai_tpu_torch.kernels import blur as tblur
from xai_tpu_torch.registry import get_attribution
from xai_tpu_torch.runners import common as TC
from xai_tpu_torch.runners import evaluate_perturbation as TP
from xai_tpu_torch.runners import image_finder as TF
from xai_tpu_torch.runners import qualitative_generation as TQ
from xai_tpu_torch.runners import sweep as TW
from xai_tpu_torch.utils import render as TR
from xai_tpu_torch.utils import saver as TS
from xai_tpu_torch.utils import visualization as TV

from torch_one_thread import one_torch_thread  # noqa: F401 (autouse)


@pytest.fixture(scope="module")
def params_path(tmp_path_factory):
    jb = jax_build_bundle("TINY_R", seed=2)
    return save_params(jb.params, str(tmp_path_factory.mktemp("params")
                                      / "tiny_r.npz"))


# --- --save_maps ---

def _maps(path):
    import h5py
    with h5py.File(path, "r") as f:
        return {n: (np.asarray(d), dict(d.attrs))
                for n, d in f["maps"].items()}


@pytest.mark.parametrize("batch", [1, 2], ids=["per_image", "batched"])
def test_save_maps_matches_xai_tpu(tmp_path, params_path, batch):
    """One dataset a scored image, the map that was scored, with its
    target and original prediction: per image, and batched (one batch of
    two and a one-image tail)."""
    flags = ["--model", "TINY_R", "--attr_func", "ig", "--synthetic", "3",
             "--image_count", "3000", "--image_batch", str(batch),
             "--params_path", params_path, "--save_maps"]
    JP.evaluate_perturbation(JP.build_parser().parse_args(
        flags + ["--output_dir", str(tmp_path / "jax")]))
    TP.evaluate_perturbation(TP.build_parser().parse_args(
        flags + ["--output_dir", str(tmp_path / "torch")]), device="cpu")
    ref = _maps(tmp_path / "jax" / "TINY_R_ig_maps.h5")
    got = _maps(tmp_path / "torch" / "TINY_R_ig_maps.h5")
    assert sorted(got) == sorted(ref) and len(got) == 3
    for name, (m, attrs) in got.items():
        rm, rattrs = ref[name]
        assert m.shape == rm.shape == (64, 64) and m.dtype == rm.dtype
        assert np.max(np.abs(m - rm)) <= 1e-5 * np.max(np.abs(rm))
        assert sorted(attrs) == sorted(rattrs) == ["original_pred",
                                                   "target"]
        assert attrs["target"] == rattrs["target"]
        assert abs(attrs["original_pred"] - rattrs["original_pred"]) < 1e-6


def test_saved_map_is_the_scored_map(tmp_path, params_path, monkeypatch):
    """The map in the file is the one the battery scored."""
    scored = []
    battery = TP.run_battery

    def spy(apply, x, saliency, *args, **kwargs):
        scored.append(np.array(saliency))
        return battery(apply, x, saliency, *args, **kwargs)

    monkeypatch.setattr(TP, "run_battery", spy)
    TP.evaluate_perturbation(TP.build_parser().parse_args(
        ["--model", "TINY_R", "--attr_func", "grad", "--synthetic", "2",
         "--image_count", "2000", "--params_path", params_path,
         "--save_maps", "--output_dir", str(tmp_path)]), device="cpu")
    saved = _maps(tmp_path / "TINY_R_grad_maps.h5")
    assert len(saved) == len(scored) == 2
    for (m, _), s in zip((saved[n] for n in sorted(saved)), scored):
        assert np.array_equal(m, s)


def test_save_maps_without_h5py_raises_first(tmp_path, params_path,
                                             monkeypatch):
    monkeypatch.setitem(sys.modules, "h5py", None)
    called = []
    monkeypatch.setattr(TP, "build_bundle", lambda *a, **k: called.append(1))
    with pytest.raises(ImportError, match="h5py"):
        TP.evaluate_perturbation(TP.build_parser().parse_args(
            ["--model", "TINY_R", "--synthetic", "1", "--image_count", "1",
             "--params_path", params_path, "--save_maps", "--output_dir",
             str(tmp_path)]), device="cpu")
    assert not called and not os.listdir(tmp_path)


# --- the image finder ---

def test_image_finder_mask_matches_xai_tpu(tmp_path, params_path):
    """Ground truth: the model's own class for even indices, another for
    odd ones; the mask must read 1, 0, 1, 0, ..."""
    bundle = TC.build_bundle("TINY_R", params_path, device="cpu")
    xs = torch.stack([TC.normalize_input(it.trans_img, "cnn", "cpu")
                      for it in ImageNetValStream("", 64, synthetic=8)])
    preds = TC.predict_classes(bundle, xs)
    gt = [p if i % 2 == 0 else (p + 1) % 1000 for i, p in enumerate(preds)]
    gt_path = tmp_path / "gt.txt"
    gt_path.write_text("".join(f"{g}\n" for g in gt))
    flags = ["--model", "TINY_R", "--synthetic", "8", "--batch_size", "3",
             "--ground_truth", str(gt_path), "--params_path", params_path]
    ref = JF.find_correctly_classified(JF.build_parser().parse_args(
        flags + ["--class_maps_dir", str(tmp_path / "jax")]))
    got = TF.find_correctly_classified(TF.build_parser().parse_args(
        flags + ["--class_maps_dir", str(tmp_path / "torch")]),
        device="cpu")
    assert got.tolist() == ref.tolist() == [1, 0] * 4
    name = "correctly_classified_TINY_R.txt"
    assert ((tmp_path / "torch" / name).read_text()
            == (tmp_path / "jax" / name).read_text())


def test_image_finder_zoo_is_xai_tpus_beyond_the_drivers():
    """The port's zoo is xai_tpu's, name for name and target for target,
    and every name outside the drivers' table goes through it."""
    from xai_tpu.models import EXTENDED_ZOO
    from xai_tpu.runners.common import MODEL_TABLE
    from xai_tpu_torch.models import EXTENDED_ZOO as PORT_ZOO
    assert PORT_ZOO == EXTENDED_ZOO
    assert set(TC.MODEL_TABLE) >= set(MODEL_TABLE) & set(EXTENDED_ZOO)
    assert len(set(EXTENDED_ZOO) - set(MODEL_TABLE)) == 15


@pytest.mark.parametrize("model", ["VIT_tiny", "pvt_tiny", "swin_tiny",
                                   "IV3"])
def test_image_finder_unported_models_raise(tmp_path, monkeypatch, model):
    """Once these zoo names raised naming ROADMAP item A13; now each runs
    at full width in the port's finder.  On one numpy weight tree (an
    .npz for the port, a pickle for xai_tpu's extended branch) both
    finders write the same mask file, 1, 0, 1, 0, ... against ground
    truth made from the port's own classes; IV3 streams 299 px crops and
    PVT's family normalization is (0.5, 0.5, 0.5) in both."""
    import pickle

    from xai_tpu import models as JM
    from xai_tpu_torch.convert.from_jax import load_params
    from xai_tpu_torch.models import get_bundle

    from test_torch_zoo import jax_module, numpy_params

    hw = 299 if model == "IV3" else 224
    tree = numpy_params(jax_module(model), hw, seed=4)
    npz = save_params(tree, str(tmp_path / "params.npz"))
    pkl = tmp_path / "params.pkl"
    with open(pkl, "wb") as f:
        pickle.dump(jax.tree.map(np.asarray, tree), f)
    # xai_tpu's extended branch inits the zoo model, then puts the pickle
    # in: hand it the tree to skip the full-width flax init
    build = JM.get_bundle
    monkeypatch.setattr(JM, "get_bundle", lambda name, params=None,
                        key=None: build(name, params=tree))

    bundle = get_bundle(model, load_params(npz), device="cpu")
    ref_meta = JM.get_bundle(model).meta
    assert bundle.meta.img_hw == ref_meta.img_hw == hw
    assert bundle.meta.family == ref_meta.family
    xs = torch.stack([TC.normalize_input(it.trans_img, bundle.meta.family,
                                         "cpu")
                      for it in ImageNetValStream("", hw, synthetic=4)])
    preds = TC.predict_classes(bundle, xs)
    gt = [p if i % 2 == 0 else (p + 1) % 1000 for i, p in enumerate(preds)]
    gt_path = tmp_path / "gt.txt"
    gt_path.write_text("".join(f"{g}\n" for g in gt))
    flags = ["--model", model, "--synthetic", "4", "--batch_size", "2",
             "--ground_truth", str(gt_path)]
    ref = JF.find_correctly_classified(JF.build_parser().parse_args(
        flags + ["--params_path", str(pkl), "--class_maps_dir",
                 str(tmp_path / "jax")]))
    got = TF.find_correctly_classified(TF.build_parser().parse_args(
        flags + ["--params_path", npz, "--class_maps_dir",
                 str(tmp_path / "torch")]), device="cpu")
    assert got.tolist() == ref.tolist() == [1, 0] * 2
    name = f"correctly_classified_{model}.txt"
    assert ((tmp_path / "torch" / name).read_text()
            == (tmp_path / "jax" / name).read_text())


# --- qualitative panels ---

def test_panel_maps_are_the_registrys(params_path):
    bundle = TC.build_bundle("TINY_R", params_path, device="cpu")
    item = next(iter(ImageNetValStream("", 64, synthetic=1)))
    panel = ["grad", "ig", "gc", "gs", "nope"]
    maps, failed = TQ.panel_maps(bundle, item, panel, 3, "cpu")
    assert list(failed) == ["nope"] and "KeyError" in failed["nope"]
    x = TC.normalize_input(item.trans_img, "cnn", "cpu")
    target = TC.predict_classes(bundle, x[None])[0]
    for name in panel[:-1]:
        ref = get_attribution("cnn", name, TC.attr_context(bundle, {
            "x": x, "trans_img": item.trans_img, "target": target,
            "generator": TC.image_generator(3, item.index, "cpu")}))
        assert np.array_equal(maps[name], ref), name


def test_generate_writes_the_grid_and_names_failures(tmp_path, params_path):
    pytest.importorskip("matplotlib")
    written = TQ.generate(TQ.build_parser().parse_args(
        ["--model", "TINY_R", "--synthetic", "2", "--image_count", "1",
         "--methods", "grad,gc,nope", "--params_path", params_path,
         "--output_dir", str(tmp_path)]), device="cpu")
    png = str(tmp_path / "TINY_R_synthetic_val_00000001.JPEG.png")
    assert written == {png: ["nope"]}
    with open(png, "rb") as f:
        assert f.read(8) == b"\x89PNG\r\n\x1a\n"


def test_panels_are_xai_tpus():
    from xai_tpu.runners import qualitative_generation as JQ
    assert TQ.CNN_PANEL == JQ.CNN_PANEL and len(TQ.CNN_PANEL) == 16
    assert TQ.VIT_PANEL == JQ.VIT_PANEL and TQ.CLIP_PANEL == JQ.CLIP_PANEL


# --- rendering helpers ---

@pytest.mark.parametrize("norm", ["absolute", "positive", "negative", "all"])
def test_normalize_attr_matches_xai_tpu(norm):
    a = np.random.RandomState(1).randn(20, 18, 3)
    np.testing.assert_array_equal(TV.normalize_attr(a, norm),
                                  JV.normalize_attr(a, norm))


@pytest.mark.parametrize("with_x", [False, True], ids=["plain", "outline"])
def test_heatmaps_match_xai_tpu(with_x):
    rs = np.random.RandomState(2)
    r = rs.randn(24, 20)
    x = rs.rand(24, 20) if with_x else None
    np.testing.assert_array_equal(TV.hm_to_rgb(r, x, scaling=2),
                                  JV.hm_to_rgb(r, x, scaling=2))
    np.testing.assert_array_equal(TR.hm_to_rgb(r, x, scaling=2),
                                  JR.hm_to_rgb(r, x, scaling=2))


def test_canny_overlay_and_enlarge_match_xai_tpu():
    rs = np.random.RandomState(3)
    img = rs.rand(30, 26)
    np.testing.assert_array_equal(TR.canny(img), JR.canny(img))
    a, b = rs.rand(8, 8, 3), rs.rand(8, 8, 3)
    np.testing.assert_array_equal(TR.overlay(a, b, 0.3),
                                  JR.overlay(a, b, 0.3))
    np.testing.assert_array_equal(TV.enlarge_image(a, 3),
                                  JV.enlarge_image(a, 3))


def test_saver_numbers_runs_as_xai_tpu(tmp_path):
    for mod, d in ((TS, tmp_path / "torch"), (JS, tmp_path / "jax")):
        first = mod.Saver(str(d), "run")
        first.save_experiment_config({"seed": 1})
        second = mod.Saver(str(d), "run")
        assert (first.run_id, second.run_id) == (0, 1)
    assert sorted(os.listdir(tmp_path / "torch")) == sorted(
        os.listdir(tmp_path / "jax"))
    assert ((tmp_path / "torch" / "run_0" / "config.json").read_text()
            == (tmp_path / "jax" / "run_0" / "config.json").read_text())


# --- the sweep ---

def test_sweep_tables_are_xai_tpus():
    assert TW.PERT_SWEEP == JW.PERT_SWEEP
    assert TW.SANITY_SWEEP == JW.SANITY_SWEEP
    assert TW.SEG_SWEEP == JW.SEG_SWEEP
    args = TW.build_parser().parse_args(["--drivers", "all"])
    assert len(TW.sweep_jobs(args)) == 217


def _records(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def test_sweep_resumes_and_records_unported_rows(tmp_path, monkeypatch):
    """Every run writes a manifest line; a run that raises is recorded
    with its error and the sweep goes on; a second sweep skips the ok
    runs and retries the failed one.  The failing row is injected: the
    seg driver raises for ig in the first sweep (the CLIP rows, which
    raised naming A11 here before, run: tests/test_torch_clip_drivers.py)."""
    argv = ["--drivers", "pert,sanity,seg", "--models", "TINY_R",
            "--methods", "grad,ig", "--synthetic", "1", "--image_count",
            "1", "--output_dir", str(tmp_path)]
    real_entry = TW._driver_entry

    def failing_seg(driver):
        parser, evaluate = real_entry(driver)
        if driver != "seg":
            return parser, evaluate

        def evaluate_or_fail(args, device=None):
            if args.attr_func == "ig":
                raise RuntimeError("injected seg failure")
            return evaluate(args, device=device)
        return parser, evaluate_or_fail

    monkeypatch.setattr(TW, "_driver_entry", failing_seg)
    first = TW.run_sweep(TW.build_parser().parse_args(argv), device="cpu")
    assert [(r["driver"], r["attr_func"], r["status"]) for r in first] == [
        (d, m, "error" if (d, m) == ("seg", "ig") else "ok")
        for d in ("pert", "sanity", "seg") for m in ("grad", "ig")]
    for r in first:
        if r["status"] == "error":
            assert "injected seg failure" in r["error"]
        else:
            assert all(np.isfinite(v) for v in r["scores"].values())
    monkeypatch.setattr(TW, "_driver_entry", real_entry)
    second = TW.run_sweep(TW.build_parser().parse_args(argv), device="cpu")
    assert [(r["driver"], r["attr_func"], r["status"]) for r in second] == [
        ("seg", "ig", "ok")]
    assert len(_records(tmp_path / "sweep_manifest.jsonl")) == 7


def test_sweep_refuses_many_processes(tmp_path, monkeypatch):
    """A multi-process sweep, which raised naming ROADMAP item A14, now
    stripes its runs as xai_tpu does: process r of n takes
    ``jobs[r::n]``, into the one manifest (the group stood in for here;
    tests/test_torch_multi_process.py runs two real processes)."""
    args = TW.build_parser().parse_args(
        ["--drivers", "pert,sanity", "--models", "TINY_R", "--methods",
         "grad,ig,gc", "--output_dir", str(tmp_path)])
    jobs = TW.sweep_jobs(args)
    assert len(jobs) == 6
    ran = []
    real = TW._driver_entry

    def entry(driver):
        def evaluate(sub, device=None):
            ran.append((driver, sub.model, sub.attr_func))
            return {"MAS_ins": 0.5}
        return real(driver)[0], evaluate

    monkeypatch.setattr(TW, "_driver_entry", entry)
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda: 3)
    for rank in (1, 2):
        monkeypatch.setattr(torch.distributed, "get_rank", lambda r=rank: r)
        ran.clear()
        records = TW.run_sweep(args)
        assert ran == jobs[rank::3]
        assert [(r["driver"], r["model"], r["attr_func"]) for r in records
                if r["status"] == "ok"] == jobs[rank::3]
    assert ([(r["driver"], r["attr_func"])
             for r in _records(tmp_path / "sweep_manifest.jsonl")]
            == [(d, a) for d, _, a in jobs[1::3] + jobs[2::3]])


# --- the blur at MDA's wider kernels ---

@pytest.mark.parametrize("form", ["dense", "pallas_interpret"])
def test_blur_plain_at_klen_103_matches_xai_tpu(form):
    """MDA's adaptive blur grows klen to 103 (and nsig with it): the plain
    version that the CPU runs against xai_tpu's dense blur and its Pallas
    kernel in interpret mode, within the kernel's 1e-5 contract."""
    x = np.random.RandomState(8).rand(1, 40, 36, 3).astype(np.float32)
    fn = {"dense": jax_gaussian_blur,
          "pallas_interpret": lambda a, k, s: pallas_blur(
              a, k, s, interpret=True)}[form]
    ref = np.asarray(fn(jnp.asarray(x), 103, 103.0))
    planes = torch.from_numpy(x.transpose(0, 3, 1, 2).reshape(3, 40, 36)
                              .copy())
    tblur.blur_planes.launches = 0
    got = tblur.blur_planes(planes, 103, 103.0).numpy()
    assert tblur.blur_planes.launches == 0      # the CPU runs no kernel
    got = got.reshape(1, 3, 40, 36).transpose(0, 2, 3, 1)
    assert np.max(np.abs(got - ref)) < 1e-5


@pytest.mark.parametrize("klen", [65, 103, 449])
def test_wide_blur_taps_are_xai_tpus(klen):
    """The wide path's taps, like the fused kernel's, are xai_tpu's
    float32 SVD factors."""
    for mine, theirs in zip(tblur._factors(klen, float(klen)),
                            jax_factors(klen, float(klen))):
        assert np.array_equal(mine, theirs) and mine.shape == (klen,)
