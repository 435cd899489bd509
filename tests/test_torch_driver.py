"""Driver-vs-driver parity: xai_tpu_torch's evaluate_perturbation against
xai_tpu's on the same .npz weights and the same images, on the CPU.

Two streams: ``--synthetic 3`` (gates skipped, as in xai_tpu) and a
directory of seeded JPEGs, where the blur/black gates run and so the blur
inside them.  The CSV rows must match, runtime rows excluded.  The LIME
case injects the same sample rows into both registries' entries.
"""
import csv
import os

import numpy as np
import pytest
import torch

from xai_tpu.runners import evaluate_perturbation as JD
from xai_tpu.runners.common import build_bundle as jax_build_bundle
from xai_tpu.runners.common import save_params

from xai_tpu_torch.runners import evaluate_perturbation as TD

HW = 64
RUNTIME_ROWS = ("Attr Avg Runtime", "Total Runtime")


def _write_images(img_dir, n=8):
    from PIL import Image
    os.makedirs(img_dir, exist_ok=True)
    rs = np.random.RandomState(7)
    for i in range(n):
        # a smooth field plus noise, not square: resize and crop both act
        yy, xx = np.mgrid[0:80, 0:72] / 80.0
        base = np.stack([yy, xx, yy * xx], -1) * rs.rand(3)
        arr = np.clip(base + 0.3 * rs.rand(80, 72, 3), 0, 1)
        Image.fromarray((arr * 255).astype(np.uint8)).save(
            os.path.join(img_dir, f"ILSVRC2012_val_{i + 1:08d}.JPEG"),
            format="JPEG", quality=95)


def _read_csv(path):
    with open(path) as f:
        return [row for row in csv.reader(f) if row]


@pytest.fixture(scope="module")
def params_path(tmp_path_factory):
    jb = jax_build_bundle("TINY_R", seed=2)
    path = str(tmp_path_factory.mktemp("params") / "tiny_r.npz")
    return save_params(jb.params, path)


@pytest.mark.parametrize("source", ["synthetic", "jpeg_dir"])
def test_driver_csv_matches_xai_tpu(tmp_path, params_path, source):
    count = 3
    if source == "synthetic":
        stream = ["--synthetic", str(count)]
    else:
        img_dir = str(tmp_path / "images")
        _write_images(img_dir)
        stream = ["--dataset_path", img_dir]
    common = ["--model", "TINY_R", "--attr_func", "ig", "--image_count",
              str(count), "--params_path", params_path, *stream]
    JD.evaluate_perturbation(JD.build_parser().parse_args(
        common + ["--output_dir", str(tmp_path / "jax")]))
    TD.evaluate_perturbation(TD.build_parser().parse_args(
        common + ["--output_dir", str(tmp_path / "torch")]), device="cpu")
    name = os.path.join("TINY_R", f"ig_{count}_images.csv")
    ref = _read_csv(tmp_path / "jax" / name)
    got = _read_csv(tmp_path / "torch" / name)
    assert [r[0] for r in got] == [r[0] for r in ref]    # same row order
    scores = [(g, r) for g, r in zip(got, ref) if r[0] not in RUNTIME_ROWS]
    assert len(scores) == 10
    for (key, g), (_, r) in scores:
        # the tolerance of tests/test_driver_csv_parity.py: the saliency
        # ranks of two float32 IG sweeps may swap near-equal pixels
        assert abs(float(g) - float(r)) < 2e-3, (key, g, r)
        assert np.isfinite(float(g))


def test_driver_lime_csv_matches_xai_tpu(tmp_path, params_path,
                                         monkeypatch):
    """--attr_func lime: both registries' entries get the same injected
    sample rows (threefry and torch's generator never draw alike)."""
    from xai_tpu import registry as jax_registry
    from xai_tpu.methods.lime import lime as jax_lime
    from xai_tpu_torch import registry as torch_registry
    from xai_tpu_torch.methods.lime import lime as torch_lime

    rs = np.random.RandomState(11)
    # 130 rows in chunks of 40: the last chunk is zero-padded in both
    rows = rs.randint(0, 2, (130, 16)).astype(np.int8)
    rows[0] = 1
    monkeypatch.setattr(jax_registry, "_lime_entry", lambda c: jax_lime(
        c.bundle, c.trans_img, c.key, chunk=40, rows=rows))
    monkeypatch.setattr(torch_registry, "_lime_entry", lambda c: torch_lime(
        c.bundle, c.trans_img, c.generator, chunk=40, rows=rows,
        device=c.x.device))
    count = 2
    common = ["--model", "TINY_R", "--attr_func", "lime", "--image_count",
              str(count), "--params_path", params_path, "--synthetic",
              str(count)]
    JD.evaluate_perturbation(JD.build_parser().parse_args(
        common + ["--output_dir", str(tmp_path / "jax")]))
    TD.evaluate_perturbation(TD.build_parser().parse_args(
        common + ["--output_dir", str(tmp_path / "torch")]), device="cpu")
    name = os.path.join("TINY_R", f"lime_{count}_images.csv")
    ref = _read_csv(tmp_path / "jax" / name)
    got = _read_csv(tmp_path / "torch" / name)
    assert [r[0] for r in got] == [r[0] for r in ref]
    scores = [(g, r) for g, r in zip(got, ref) if r[0] not in RUNTIME_ROWS]
    assert len(scores) == 10
    for (key, g), (_, r) in scores:
        # equal masks give equal reveal orders; what is left is the
        # battery's float32 forwards in two libraries
        assert abs(float(g) - float(r)) < 2e-3, (key, g, r)
        assert np.isfinite(float(g))


def test_image_generators_are_seeded_per_image():
    draw = [torch.randint(0, 2 ** 30, (4,), generator=TD.image_generator(
        seed, index, "cpu")) for seed, index in ((0, 5), (0, 5), (0, 6),
                                                 (1, 5))]
    assert torch.equal(draw[0], draw[1])
    assert not torch.equal(draw[0], draw[2])
    assert not torch.equal(draw[0], draw[3])


@pytest.mark.parametrize("flag", [
    ["--image_batch", "2"], ["--attr_dtype", "bf16"], ["--shard_images"],
    ["--save_maps"], ["--profile_dir", "trace"]],
    ids=lambda f: f[0].lstrip("-"))
def test_unported_flags_raise(tmp_path, params_path, flag):
    args = TD.build_parser().parse_args(
        ["--model", "TINY_R", "--synthetic", "1", "--image_count", "1",
         "--params_path", params_path, "--output_dir", str(tmp_path),
         *flag])
    with pytest.raises(NotImplementedError, match="ROADMAP.md item A"):
        TD.evaluate_perturbation(args, device="cpu")
    assert not os.listdir(tmp_path)


def test_unported_model_and_method_raise(tmp_path):
    base = ["--synthetic", "1", "--image_count", "1", "--output_dir",
            str(tmp_path)]
    with pytest.raises(NotImplementedError, match="A10"):
        TD.evaluate_perturbation(TD.build_parser().parse_args(
            ["--model", "VIT16", *base]), device="cpu")
    with pytest.raises(KeyError, match="unknown cnn attribution 'nope'"):
        TD.evaluate_perturbation(TD.build_parser().parse_args(
            ["--model", "TINY_R", "--attr_func", "nope", *base]),
            device="cpu")
