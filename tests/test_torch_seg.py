"""The segmentation metrics, dataset reader and driver of xai_tpu_torch
against xai_tpu's, on the CPU.

xai_tpu takes average precision and F1 from scikit-learn; the port writes
them out in numpy, so they are also held against scikit-learn here.
"""
import os
import warnings

import numpy as np
import pytest

from xai_tpu.data.segmentation import ImagenetSegmentation as JSeg
from xai_tpu.metrics import seg as JM
from xai_tpu.runners import evaluate_imagenet_seg as JD
from xai_tpu.runners.common import build_bundle as jax_build_bundle
from xai_tpu.runners.common import save_params

from xai_tpu_torch.data.segmentation import ImagenetSegmentation as TSeg
from xai_tpu_torch.metrics import seg as TM
from xai_tpu_torch.runners import evaluate_imagenet_seg as TD

from torch_one_thread import one_torch_thread  # noqa: F401 (autouse)


def _case(kind, rs, hw=48):
    """(saliency, gt mask) pairs of several kinds."""
    sal = rs.rand(hw, hw)
    gt = (rs.rand(hw, hw) < 0.3).astype(np.int64)
    if kind == "ties":
        sal = np.round(sal, 1)
    elif kind == "empty_mask":
        gt[:] = 0
    elif kind == "full_mask":
        gt[:] = 1
    elif kind == "constant_map":
        sal[:] = 0.5
    return sal, gt


KINDS = ["random", "ties", "empty_mask", "full_mask", "constant_map"]


@pytest.mark.parametrize("kind", KINDS)
def test_eval_batch_matches_xai_tpu(kind):
    sal, gt = _case(kind, np.random.RandomState(KINDS.index(kind)))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")          # sklearn: no positives
        ref = JM.eval_batch(sal, gt)
    got = TM.eval_batch(sal, gt)
    for g, r in zip(got, ref):
        assert np.abs(np.asarray(g, np.float64)
                      - np.asarray(r, np.float64)).max() <= 1e-12, (g, r)


@pytest.mark.parametrize("kind", KINDS)
def test_metric_pieces_match_xai_tpu(kind):
    rs = np.random.RandomState(10 + KINDS.index(kind))
    sal, gt = _case(kind, rs)
    two = np.stack([1 - sal, sal])
    for fn in ("batch_pix_accuracy", "batch_intersection_union"):
        for g, r in zip(getattr(TM, fn)(two, gt), getattr(JM, fn)(two, gt)):
            assert np.array_equal(g, r)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for fn, arg in (("get_ap_scores", two),
                        ("get_f1_scores", sal > 0.5)):
            g, r = getattr(TM, fn)(arg, gt), getattr(JM, fn)(arg, gt)
            assert abs(g[0] - r[0]) <= 1e-12, (fn, g, r)
    got, ref = TM.best_threshold(sal, gt), JM.best_threshold(sal, gt)
    assert np.abs(got[0] - ref[0]).max() <= 1e-12 and got[1] == ref[1]
    assert np.array_equal(TM.MAG_VALS, JM.MAG_VALS)


def _sklearn_case(kind, rs, n=2000):
    y = (rs.rand(n) < 0.4).astype(np.float64)
    if kind == "hard":
        s = (rs.rand(n) < 0.5).astype(np.float64)
    elif kind == "tied_scores":
        s = np.round(rs.rand(n), 1)
    elif kind == "all_zero_mask":
        y[:] = 0
        s = rs.rand(n)
    else:                                        # all-zero prediction
        s = np.zeros(n)
    return y, s


@pytest.mark.parametrize("kind", ["hard", "tied_scores", "all_zero_mask",
                                  "all_zero_prediction"])
def test_ap_and_f1_equal_sklearn(kind):
    from sklearn.metrics import average_precision_score, f1_score

    y, s = _sklearn_case(kind, np.random.RandomState(7))
    pred = (s > 0.5).astype(np.int8)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ap = average_precision_score(y, s)
        f1 = f1_score(y.astype(int), pred)
    assert abs(TM.average_precision(y, s) - np.nan_to_num(ap)) <= 1e-12
    assert abs(TM.f1_binary(y.astype(int), pred) - f1) <= 1e-12


def test_synthetic_stream_is_xai_tpus():
    got = list(TSeg("", img_hw=40, synthetic=4, seed=3))
    ref = list(JSeg("", img_hw=40, synthetic=4, seed=3))
    assert len(got) == len(ref) == 4
    for g, r in zip(got, ref):
        assert np.array_equal(g.trans_img, r.trans_img)
        assert g.trans_img.dtype == r.trans_img.dtype
        assert np.array_equal(g.gt_mask, r.gt_mask)
        assert g.gt_mask.dtype == r.gt_mask.dtype


def _write_gtsegs(path, n=3):
    """A small file in gtsegs_ijcv.mat's HDF5 layout: /value/img and
    /value/gt hold object references; an image is stored [C, W, H], a
    mask [W, H] behind a second reference."""
    import h5py

    rs = np.random.RandomState(4)
    with h5py.File(path, "w") as f:
        refs = f.create_group("refs")
        img_refs, gt_refs = [], []
        for i in range(n):
            h, w = 50 + 7 * i, 61 - 5 * i
            img = (rs.rand(3, w, h) * 255).astype(np.uint8)
            mask = (rs.rand(w, h) < 0.4).astype(np.uint8)
            img_refs.append(refs.create_dataset(f"img{i}", data=img).ref)
            m = refs.create_dataset(f"mask{i}", data=mask)
            holder = refs.create_dataset(f"gt{i}", (1, 1),
                                         dtype=h5py.ref_dtype)
            holder[0, 0] = m.ref
            gt_refs.append(holder.ref)
        value = f.create_group("value")
        value.create_dataset("img", data=np.array(img_refs)[:, None],
                             dtype=h5py.ref_dtype)
        value.create_dataset("gt", data=np.array(gt_refs)[:, None],
                             dtype=h5py.ref_dtype)


def test_real_file_reader_is_xai_tpus(tmp_path):
    path = str(tmp_path / "gtsegs.mat")
    _write_gtsegs(path)
    got, ref = TSeg(path, img_hw=32), JSeg(path, img_hw=32)
    assert len(got) == len(ref) == 3
    items = list(got)
    for g, r in zip(items, ref):
        assert np.array_equal(g.trans_img, r.trans_img)
        assert np.array_equal(g.gt_mask, r.gt_mask)
        assert g.trans_img.shape == (32, 32, 3) and g.gt_mask.shape == (32, 32)
    assert any(it.gt_mask.any() for it in items)


@pytest.fixture(scope="module")
def params_path(tmp_path_factory):
    jb = jax_build_bundle("TINY_R", seed=2)
    return save_params(jb.params, str(tmp_path_factory.mktemp("params")
                                      / "tiny_r.npz"))


def _run(pkg, tmp_path, flags):
    d = tmp_path / f"{pkg}{len(os.listdir(tmp_path))}"
    mod = JD if pkg == "jax" else TD
    args = mod.build_parser().parse_args(
        ["--model", "TINY_R", *flags, "--output_dir", str(d)])
    if pkg == "jax":
        scores = mod.evaluate_imagenet_seg(args)
    else:
        scores = mod.evaluate_imagenet_seg(args, device="cpu")
    with open(d / "TINY_R" / f"{args.attr_func}_{args.image_count}"
                             f"_images") as f:
        lines = f.read().splitlines()
    return scores, lines


def _layout(lines):
    return [line.split(":")[0] for line in lines]


@pytest.mark.parametrize("batch", [1, 2], ids=["per_image", "batched"])
@pytest.mark.parametrize("name", ["ig", "gc"])
def test_seg_txt_matches_xai_tpu(tmp_path, params_path, name, batch):
    """Three images; batched: one batch of two and a flushed tail."""
    flags = ["--attr_func", name, "--synthetic", "3", "--image_batch",
             str(batch), "--params_path", params_path]
    ref, ref_lines = _run("jax", tmp_path, flags)
    got, got_lines = _run("torch", tmp_path, flags)
    assert _layout(got_lines) == _layout(ref_lines) and len(got_lines) == 4
    assert list(got) == list(ref)
    for k in ref:
        # the driver tolerance of tests/test_torch_driver.py
        assert abs(got[k] - ref[k]) < 2e-3, (k, got[k], ref[k])
        assert np.isfinite(got[k])


def test_per_image_seg_ignores_attr_dtype(tmp_path, params_path):
    """xai_tpu's quirk, kept: the per-image path builds its context
    without the dtype, so --attr_dtype bf16 acts only under
    --image_batch."""
    flags = ["--attr_func", "ig", "--synthetic", "2", "--params_path",
             params_path]
    f32, _ = _run("torch", tmp_path, flags)
    bf16, _ = _run("torch", tmp_path, flags + ["--attr_dtype", "bf16"])
    assert f32 == bf16
    batched = ["--image_batch", "2"]
    f32b, _ = _run("torch", tmp_path, flags + batched)
    bf16b, _ = _run("torch", tmp_path, flags + batched +
                    ["--attr_dtype", "bf16"])
    assert f32b != bf16b


def test_seg_unported_paths_raise(tmp_path):
    base = ["--synthetic", "1", "--output_dir", str(tmp_path)]
    with pytest.raises(NotImplementedError, match="A10"):
        TD.evaluate_imagenet_seg(TD.build_parser().parse_args(
            ["--model", "VIT16", *base]), device="cpu")
    with pytest.raises(NotImplementedError, match="A14"):
        TD.evaluate_imagenet_seg(TD.build_parser().parse_args(
            ["--model", "TINY_R", "--shard_images", *base]), device="cpu")
    assert not os.listdir(tmp_path)
