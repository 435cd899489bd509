"""Driver-vs-driver parity: xai_tpu_torch's evaluate_perturbation against
xai_tpu's on the same .npz weights and the same images, on the CPU.

Two streams: ``--synthetic 3`` (gates skipped, as in xai_tpu) and a
directory of seeded JPEGs, where the blur/black gates run and so the blur
inside them.  The CSV rows must match, runtime rows excluded.  The LIME
case injects the same sample rows into both registries' entries.  The
batched path (``--image_batch 2`` over three images: one batch and a
one-image tail) is held against xai_tpu's, in float32 and in bf16.
"""
import csv
import json
import os

import numpy as np
import pytest
import torch

from xai_tpu.runners import evaluate_perturbation as JD
from xai_tpu.runners.common import build_bundle as jax_build_bundle
from xai_tpu.runners.common import save_params

from xai_tpu_torch.runners import evaluate_perturbation as TD

from torch_one_thread import one_torch_thread  # noqa: F401 (autouse)

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


def _patch_fa(monkeypatch):
    """Both registries' fa entry on a 32x32 patch grid (2 px patches):
    xai_tpu's patch mask needs the image size to be a multiple of the
    grid, and its driver's 14x14 raises at TINY_R's 64 px.  With larger
    patches the map's plateaus hold many pixels within the two
    libraries' last-bit differences (fa subtracts nearby logits; the maps
    agree within 3e-5 relative), their reveal order differs, and the
    discrete scores move: AIC_del by one step of 1/32 at 8 px patches,
    MONO_pos by 2.1e-3 at 4 px."""
    from xai_tpu import registry as jax_registry
    from xai_tpu.methods import ablation as JAB
    from xai_tpu_torch import registry as torch_registry
    from xai_tpu_torch.methods import ablation as TAB

    for reg, ab in ((jax_registry, JAB), (torch_registry, TAB)):
        monkeypatch.setitem(reg.CNN_METHODS, "fa", reg._abs_sum(
            lambda c, reg=reg, ab=ab: reg._down_up(ab.feature_ablation(
                c.bundle, c.x, c.target, num_patches=32), c.img_hw)))


@pytest.mark.parametrize("name,batch", [("gc", 1), ("fa", 1), ("gc", 2)],
                         ids=["gc", "fa", "gc_batched"])
def test_driver_a8_csv_matches_xai_tpu(tmp_path, params_path, monkeypatch,
                                       name, batch):
    """Two methods of the rest of the CNN family through both drivers on
    the same weights, image by image (and gc batched: one batch of two and
    a tail of one)."""
    if name == "fa":
        _patch_fa(monkeypatch)
    flags = ["--attr_func", name, "--synthetic", "3", "--image_count",
             "3000" if batch > 1 else "3", "--image_batch", str(batch)]
    ref = _run(tmp_path, "jax", "TINY_R", params_path, flags)
    got = _run(tmp_path, "torch", "TINY_R", params_path, flags)
    assert list(got) == list(ref) and len(got) == 10
    for k in ref:
        # the tolerance of the IG CSV case
        assert abs(got[k] - ref[k]) < 2e-3, (k, got[k], ref[k])
        assert np.isfinite(got[k])


@pytest.mark.parametrize("name", ["gig", "agi", "gbp", "ggc", "gs", "occ",
                                  "shap", "rise", "xrai"])
def test_a8_names_run_the_driver_on_the_cpu(tmp_path, params_path, name):
    """The rest of the CNN family (gc and fa above) through the port's
    driver on TINY_R at the production constants: 10 finite scores."""
    scores = _run(tmp_path, "torch", "TINY_R", params_path,
                  ["--attr_func", name, "--synthetic", "1", "--image_count",
                   "1"])
    assert len(scores) == 10
    assert all(np.isfinite(v) for v in scores.values()), scores


def test_image_generators_are_seeded_per_image():
    draw = [torch.randint(0, 2 ** 30, (4,), generator=TD.image_generator(
        seed, index, "cpu")) for seed, index in ((0, 5), (0, 5), (0, 6),
                                                 (1, 5))]
    assert torch.equal(draw[0], draw[1])
    assert not torch.equal(draw[0], draw[2])
    assert not torch.equal(draw[0], draw[3])


def _scores(path):
    return {r[0]: float(r[1]) for r in _read_csv(path)
            if r[0] not in RUNTIME_ROWS}


BATCHED = ["--image_batch", "2", "--synthetic", "3", "--image_count",
           "3000"]      # 3 images a class: one batch of two, a tail of one


def _run(tmp_path, pkg, model, params_path, flags):
    """One driver run of ``pkg`` ("jax" or "torch"); its CSV's scores."""
    d = tmp_path / f"{pkg}{len(os.listdir(tmp_path))}"
    args = (JD if pkg == "jax" else TD).build_parser().parse_args(
        ["--model", model, "--params_path", params_path, *flags,
         "--output_dir", str(d)])
    if pkg == "jax":
        JD.evaluate_perturbation(args)
    else:
        TD.evaluate_perturbation(args, device="cpu")
    return _scores(d / model / f"{args.attr_func}_{args.image_count}"
                                f"_images.csv")


def test_batched_driver_csv_matches_xai_tpu(tmp_path, params_path):
    flags = ["--attr_func", "ig", *BATCHED]
    ref = _run(tmp_path, "jax", "TINY_R", params_path, flags)
    got = _run(tmp_path, "torch", "TINY_R", params_path, flags)
    assert list(got) == list(ref) and len(got) == 10
    for k in ref:
        # the tolerance of the per-image CSV case
        assert abs(got[k] - ref[k]) < 2e-3, (k, got[k], ref[k])
        assert np.isfinite(got[k])


def test_batched_driver_bf16_contract(tmp_path):
    """--attr_dtype bf16 moves the battery's scores by less than 0.05 from
    float32 and from xai_tpu's bf16 run: xai_tpu's contract, on its
    configuration (tests/test_image_batch_runner.py:38-52, TINY_CNN at
    224 px, two images in one batch).  On TINY_R at 64 px the top-1 and
    monotonicity scores of random weights swing by more than 0.05 between
    bf16 and float32 in xai_tpu itself."""
    params = save_params(jax_build_bundle("TINY_CNN").params,
                         str(tmp_path / "tiny_cnn.npz"))
    flags = ["--attr_func", "ig", "--image_batch", "2", "--synthetic", "2",
             "--image_count", "2"]
    bf16 = flags + ["--attr_dtype", "bf16"]
    f32 = _run(tmp_path, "torch", "TINY_CNN", params, flags)
    got = _run(tmp_path, "torch", "TINY_CNN", params, bf16)
    ref = _run(tmp_path, "jax", "TINY_CNN", params, bf16)
    assert len(got) == 10
    for k in f32:
        assert abs(f32[k] - got[k]) < 0.05, (k, f32[k], got[k])
        assert abs(ref[k] - got[k]) < 0.05, (k, ref[k], got[k])


def test_batched_driver_equals_per_image(tmp_path, params_path):
    """One batch plus a tail against the per-image loop.  (sg, which draws
    from the per-image generators, is held batched against per-image in
    test_torch_batch.py: the driver's 25 samples of 50 steps are too many
    for the CPU suite.)"""
    flags = ["--attr_func", "ig", "--synthetic", "3", "--image_count",
             "3000"]
    seq = _run(tmp_path, "torch", "TINY_R", params_path, flags)
    bat = _run(tmp_path, "torch", "TINY_R", params_path,
               flags + ["--image_batch", "2"])
    for k in seq:
        # xai_tpu's tolerance for the same check (test_image_batch_runner)
        assert abs(seq[k] - bat[k]) < 5e-4, (k, seq[k], bat[k])


@pytest.mark.parametrize("flag", [
    ["--shard_images"], ["--profile_dir", "trace"]],
    ids=lambda f: f[0].lstrip("-"))
def test_unported_flags_raise(tmp_path, params_path, flag):
    """Both flags, which raised naming ROADMAP item A14, now run:
    --shard_images without a process group is the plain run, and
    --profile_dir (through main) writes a Chrome trace of the run; either
    way the CSV is the plain run's, runtime rows aside."""
    common = ["--model", "TINY_R", "--synthetic", "1", "--image_count", "1",
              "--params_path", params_path]
    TD.main(common + ["--output_dir", str(tmp_path / "plain")],
            device="cpu")
    if flag[0] == "--profile_dir":
        flag = [flag[0], str(tmp_path / flag[1])]
    args = TD.build_parser().parse_args(
        common + ["--output_dir", str(tmp_path / "flag"), *flag])
    TD.main(common + ["--output_dir", str(tmp_path / "flag"), *flag],
            device="cpu")
    rows = [_read_csv(tmp_path / d / "TINY_R" / "ig_1_images.csv")
            for d in ("plain", "flag")]
    assert ([r for r in rows[0] if r[0] not in RUNTIME_ROWS]
            == [r for r in rows[1] if r[0] not in RUNTIME_ROWS])
    assert len(rows[0]) == 12
    if flag[0] == "--profile_dir":
        assert os.listdir(flag[1]) == ["TINY_R_ig_p0.trace.json"]
        with open(TD.trace_path(args)) as f:
            events = json.load(f)["traceEvents"]
        # CPU events of the bundle's build and of the battery's forwards
        names = {e.get("name") for e in events}
        assert "aten::conv2d" in names and len(events) > 100


def test_unported_model_and_method_raise(tmp_path, monkeypatch):
    """CLIP16, which raised naming A11, now runs (on the driver-sized
    tiny CLIP: tests/test_torch_clip_drivers.py holds its scores); an
    unknown method still raises."""
    from test_torch_clip import CLIP_DRIVER
    from xai_tpu_torch.models import clip as tclip

    monkeypatch.setitem(tclip.CONFIGS, "clip_vit_b16",
                        tclip.CLIPConfig(**CLIP_DRIVER))
    base = ["--synthetic", "1", "--image_count", "1", "--output_dir",
            str(tmp_path)]
    scores = TD.evaluate_perturbation(TD.build_parser().parse_args(
        ["--model", "CLIP16", "--attr_func", "eclip", *base]), device="cpu")
    assert len(scores) == 10 and all(np.isfinite(v) for v in
                                     scores.values())
    assert (tmp_path / "CLIP16" / "eclip_1_images.csv").exists()
    with pytest.raises(KeyError, match="unknown cnn attribution 'nope'"):
        TD.evaluate_perturbation(TD.build_parser().parse_args(
            ["--model", "TINY_R", "--attr_func", "nope", *base]),
            device="cpu")
