"""The library API of xai_tpu_torch against xai_tpu's, on the CPU.

Every name of each xai_tpu subpackage's ``__all__`` resolves from the
port's matching subpackage (or from the counterpart named in
``COUNTERPARTS``), and importing them imports neither jax, xai_tpu nor
triton and builds no kernel.  The functions the library entry point added
run both packages on the same seeded inputs: ``load_and_preprocess`` and
``denormalize`` on image files written here, the tensor ``auc`` and
``spearman``, ``ig_batch`` on TINY_R, MAS calibration's two search
entries on the 32 px test ViT, ``native.quickshift`` and the kernels'
``separable_blur``.
"""
import importlib
import json
import os
import pkgutil
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats
import torch
from PIL import Image

import xai_tpu
import xai_tpu.native as JN
from xai_tpu.kernels.blur_pallas import separable_blur as jax_separable_blur
from xai_tpu.methods import gradient as JG
from xai_tpu.methods import mas_calibrate as JMC
from xai_tpu.ops import preprocess as JP
from xai_tpu.ops import stats as JS
from xai_tpu.ops.blur import make_blur_fn as jax_blur
from xai_tpu.runners.common import build_bundle as jax_build_bundle
from xai_tpu.runners.common import save_params

from xai_tpu_torch import native as TN
from xai_tpu_torch.kernels import separable_blur
from xai_tpu_torch.methods import gradient as TG
from xai_tpu_torch.methods import mas_calibrate as TMC
from xai_tpu_torch.methods import mda as TM
from xai_tpu_torch.ops import preprocess as TP
from xai_tpu_torch.ops import stats as TS
from xai_tpu_torch.ops.blur import make_blur_fn
from xai_tpu_torch.runners.common import build_bundle

from test_torch_batch import tiny_twins  # noqa: F401 (a fixture)
from test_torch_vit import close
from test_torch_vit_slice2 import TARGETS, _grid_segments, assert_picks, \
    twins as vit_twins  # noqa: F401 (a fixture)
from torch_one_thread import one_torch_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# xai_tpu's subpackages that declare an __all__
SUBPACKAGES = ("convert", "data", "kernels", "methods", "metrics", "models",
               "ops", "parallel", "utils")
# (subpackage, xai_tpu's name) -> the port's counterpart, a dotted path
# inside the port's subpackage
COUNTERPARTS = {
    ("kernels", "pallas_blur"): "blur_planes",
    ("kernels", "pallas_reveal_batch"): "reveal_batch",
    ("models", "ModelBundle"): "common.ModelBundle",
}


def port_names(pkg: str) -> list:
    """The port's path of every name in xai_tpu's ``__all__`` of
    ``pkg``."""
    names = importlib.import_module(f"xai_tpu.{pkg}").__all__
    return [COUNTERPARTS.get((pkg, n), n) for n in names]


def resolve(pkg: str, path: str):
    """``from xai_tpu_torch.<pkg> import <head>``, then the attributes of
    the rest of ``path``."""
    head, *rest = path.split(".")
    obj = getattr(importlib.import_module(f"xai_tpu_torch.{pkg}"), head,
                  None)
    if obj is None:                         # a submodule, imported on demand
        obj = importlib.import_module(f"xai_tpu_torch.{pkg}.{head}")
    for part in rest:
        obj = getattr(obj, part)
    return obj


def test_subpackages_are_every_one_with_an_all():
    found = []
    for m in pkgutil.iter_modules(xai_tpu.__path__):
        if m.ispkg and hasattr(importlib.import_module(
                f"xai_tpu.{m.name}"), "__all__"):
            found.append(m.name)
    assert sorted(found) == sorted(SUBPACKAGES)


@pytest.mark.parametrize("pkg", SUBPACKAGES)
def test_every_xai_tpu_name_resolves(pkg):
    port = importlib.import_module(f"xai_tpu_torch.{pkg}")
    for path in port_names(pkg):
        assert resolve(pkg, path) is not None, (pkg, path)
    # a port __all__ lists only what the package has
    for name in getattr(port, "__all__", ()):
        assert hasattr(port, name), (pkg, name)


_IMPORT_API = r"""
import importlib, json, sys
from xai_tpu_torch.kernels import _build
calls = []
_build.build = lambda *a, **k: calls.append(("build", a))
_build.load = lambda *a, **k: calls.append(("load", a))
from xai_tpu_torch.metrics import run_battery
from xai_tpu_torch.ops import make_blur_fn, load_and_preprocess, spearman, auc
for pkg, paths in json.loads(sys.argv[1]).items():
    mod = importlib.import_module("xai_tpu_torch." + pkg)
    for path in paths:
        head, *rest = path.split(".")
        obj = getattr(mod, head, None) or importlib.import_module(
            mod.__name__ + "." + head)
        for part in rest:
            obj = getattr(obj, part)
bad = sorted(k for k in sys.modules
             if k.split(".")[0] in ("jax", "jaxlib", "flax", "xai_tpu",
                                    "triton"))
assert not bad, bad
assert not calls, calls
print("ok")
"""


def test_library_api_imports_alone():
    """The Quick start's imports and every name above, in a fresh
    process: no jax, no xai_tpu, no triton, no kernel built or loaded."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    names = {pkg: port_names(pkg) for pkg in SUBPACKAGES}
    r = subprocess.run([sys.executable, "-c", _IMPORT_API,
                        json.dumps(names)], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "ok"


# --- load_and_preprocess / denormalize ---

# (mode, size (w, h), format): non-square both ways, square, smaller than
# the crop, and the modes the reference skips
IMAGES = [("RGB", (400, 300), "JPEG"), ("RGB", (300, 400), "PNG"),
          ("RGB", (256, 256), "PNG"), ("RGB", (97, 61), "JPEG"),
          ("L", (400, 300), "PNG"), ("RGBA", (300, 400), "PNG"),
          ("P", (256, 200), "PNG"), ("CMYK", (300, 300), "JPEG")]
STATS = {"imagenet": (JP.IMAGENET_MEAN, JP.IMAGENET_STD),
         "vit": (JP.VIT_MEAN, JP.VIT_STD), "clip": (JP.CLIP_MEAN, JP.CLIP_STD)}


def write_image(tmp_path, mode, size, fmt, seed) -> str:
    w, h = size
    rgb = (np.random.RandomState(seed).rand(h, w, 3) * 255).astype(np.uint8)
    path = str(tmp_path / f"img_{mode}.{fmt.lower()}")
    Image.fromarray(rgb, "RGB").convert(mode).save(path, fmt)
    return path


@pytest.mark.parametrize("case", range(len(IMAGES)))
def test_load_and_preprocess_matches(tmp_path, case):
    mode, size, fmt = IMAGES[case]
    path = write_image(tmp_path, mode, size, fmt, case)
    for hw, stats in ((224, "imagenet"), (32, "vit"), (224, "clip")):
        mean, std = STATS[stats]
        ref = JP.load_and_preprocess(path, hw, mean, std)
        got = TP.load_and_preprocess(path, hw, mean, std, device="cpu")
        if ref is None:
            assert got is None, (mode, hw)
            continue
        assert mode == "RGB"
        trans, x = got
        assert isinstance(trans, np.ndarray) and trans.shape == (hw, hw, 3)
        assert x.shape == (1, hw, hw, 3) and x.dtype == torch.float32
        np.testing.assert_allclose(trans, ref[0], rtol=0, atol=1e-6)
        np.testing.assert_allclose(x.numpy(), np.asarray(ref[1]), rtol=0,
                                   atol=1e-6)
        back = TP.denormalize(x, mean, std)
        np.testing.assert_allclose(
            back.numpy(), np.asarray(JP.denormalize(ref[1], mean, std)),
            rtol=0, atol=1e-6)
        np.testing.assert_allclose(back[0].numpy(), trans, rtol=0, atol=1e-6)


def test_load_and_preprocess_runs_on_cuda_by_default(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this checks the behaviour on a machine without CUDA")
    path = write_image(tmp_path, "RGB", (64, 48), "PNG", 0)
    with pytest.raises(RuntimeError, match="CUDA"):
        TP.load_and_preprocess(path)


# --- auc / spearman ---

def curves(seed, dtype):
    """Two 225-point curves in [0, 1] with runs of ties."""
    rs = np.random.RandomState(seed)
    a = np.round(rs.rand(225) * 8) / 8
    b = rs.rand(225)
    b[::9] = b[4]
    return a.astype(dtype), b.astype(dtype)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("seed", range(3))
def test_auc_and_spearman_match(dtype, seed):
    a, b = curves(seed, dtype)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    want = torch.float64 if dtype == np.float64 else torch.float32

    got = TS.auc(ta)
    assert got.dtype == want
    assert abs(float(got) - float(JS.auc(jnp.asarray(a)))) <= 1e-6
    assert abs(float(got) - TS.auc_np(a)) <= 1e-6

    rho = TS.spearman(ta, tb)
    assert rho.dtype == want
    assert abs(float(rho) - float(JS.spearman(a, b))) <= 1e-6
    assert abs(float(rho) - scipy.stats.spearmanr(a, b)[0]) <= 1e-6
    for x in (ta, tb):
        ranks = TS._average_ranks(x)
        assert ranks.dtype == want
        np.testing.assert_array_equal(ranks.numpy(),
                                      scipy.stats.rankdata(x.numpy()))
        np.testing.assert_array_equal(
            ranks.numpy(), np.asarray(JS._average_ranks(jnp.asarray(x))))


def test_mas_calibration_scores_with_the_ops_auc():
    assert TMC.auc is TS.auc


# --- ig_batch ---

HW = 32
STEPS = 8


@pytest.fixture(scope="module")
def tiny_r(tmp_path_factory):
    jb = jax_build_bundle("TINY_R", seed=5)
    path = str(tmp_path_factory.mktemp("params") / "tiny_r.npz")
    save_params(jb.params, path)
    tb = build_bundle("TINY_R", path, device="cpu")
    xs = np.random.RandomState(2).randn(2, HW, HW, 3).astype(np.float32)
    targets = np.array([3, 700])
    return jb, tb, xs, targets


@pytest.mark.parametrize("chunk", [16, 5, 100])
def test_ig_batch_matches_xai_tpu_and_single_images(tiny_r, chunk):
    """chunk 16 divides B * steps = 16; 5 steps down to 4; 100 to 16."""
    jb, tb, xs, targets = tiny_r
    got = TG.ig_batch(tb, torch.from_numpy(xs), torch.from_numpy(targets),
                      steps=STEPS, chunk=chunk)
    assert got.shape == xs.shape and got.dtype == torch.float32
    ref = np.asarray(JG.ig_batch(jb, jnp.asarray(xs), targets, steps=STEPS,
                                 chunk=chunk))
    close(got.numpy(), ref, 1e-4)
    for i in range(2):
        single = TG.ig(tb, torch.from_numpy(xs[i]), int(targets[i]),
                       steps=STEPS)
        torch.testing.assert_close(got[i], single, rtol=1e-5, atol=1e-6)


def test_ig_batch_bf16_runs_the_bf16_copy(tiny_twins):
    """dtype=bf16: the cast copy sees bf16 images and the result is
    float32, ranked as the float32 result on the tiny CNN of xai_tpu's
    bf16 contract (Spearman rho > 0.98)."""
    _, tb = tiny_twins
    xs = torch.from_numpy(np.random.RandomState(9).randn(2, 16, 16, 3)
                          .astype(np.float32))
    targets = torch.tensor([2, 5])
    seen = []
    hook = tb.cast(torch.bfloat16).module.register_forward_pre_hook(
        lambda m, a: seen.append(a[0].dtype))
    try:
        got = TG.ig_batch(tb, xs, targets, steps=STEPS, dtype=torch.bfloat16)
    finally:
        hook.remove()
    assert seen and set(seen) == {torch.bfloat16}
    assert got.dtype == torch.float32
    f32 = TG.ig_batch(tb, xs, targets, steps=STEPS)
    for i in range(2):
        rho = TS.spearman_np(TG.to_saliency(got[i]), TG.to_saliency(f32[i]))
        assert rho > 0.98, rho


# --- MAS calibration's two search entries ---

def _prior(seed):
    return np.abs(np.random.RandomState(seed).randn(32, 32, 3)).astype(
        np.float32)


@pytest.mark.parametrize("i", range(2))
def test_insertion_entry_is_mdas_insertion_search(vit_twins, i):
    jb, tb, xs, _ = vit_twins
    seg, prior, x = _grid_segments(), _prior(i), torch.from_numpy(xs[i])
    got = TMC.find_best_segment_reverse_informed(
        tb, x, prior, seg, make_blur_fn(31, 31.0), 16, target=TARGETS[i])
    want = TM.find_insertion_patches(tb, x, prior, seg,
                                     make_blur_fn(31, 31.0), 16,
                                     target=TARGETS[i])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    ref = JMC.find_best_segment_reverse_informed(
        jb, xs[i], prior, seg, jax_blur(31, 31.0), 16, target=TARGETS[i])
    start = np.asarray(jax_blur(31, 31.0)(jnp.asarray(xs[i])[None])[0])
    r = assert_picks(tb, got[0], ref[0], start, xs[i], seg, TARGETS[i])
    np.testing.assert_allclose(got[1][:r], ref[1][:r], atol=1e-5)


def test_deletion_entry_is_mdas_deletion_search(vit_twins):
    jb, tb, xs, _ = vit_twins
    seg, prior, x = _grid_segments(), _prior(7), torch.from_numpy(xs[1])
    seed_order = list(np.random.RandomState(8).permutation(16)[:12])
    got = TMC.find_deletion_from_insertion_informed_ultimate(
        tb, x, seg, prior, seed_order, make_blur_fn(31, 31.0), 16,
        target=TARGETS[1])
    map_0, _, map_10 = TM.find_deletion_patches(
        tb, x, seg, prior, seed_order, make_blur_fn(31, 31.0), 16,
        target=TARGETS[1])
    assert len(got) == 2
    np.testing.assert_array_equal(got[0], map_0)
    np.testing.assert_array_equal(got[1], map_10)
    ref = JMC.find_deletion_from_insertion_informed_ultimate(
        jb, xs[1], seg, prior, seed_order, jax_blur(31, 31.0), 16,
        target=TARGETS[1])
    for g, r in zip(got, ref):
        close(g, r, 1e-4)


# --- native.quickshift, separable_blur ---

@pytest.mark.parametrize("kw", [{}, {"kernel_size": 2.0, "max_dist": 10.0},
                                {"ratio": 0.5, "kernel_size": 3.0,
                                 "max_dist": 20.0}])
def test_native_quickshift_labels_equal(kw):
    rs = np.random.RandomState(4)
    # smooth blobs plus noise, so that there are several segments
    yy, xx = np.mgrid[:48, :48] / 48.0
    img = np.stack([np.sin(6 * xx), np.cos(5 * yy), xx * yy], -1) * 0.5 \
        + 0.5 + 0.05 * rs.randn(48, 48, 3)
    img = img.astype(np.float32)
    got = TN.quickshift(img, **kw)
    assert got.dtype == np.int32 and got.shape == (48, 48)
    np.testing.assert_array_equal(got, JN.quickshift(img, **kw))
    assert got.max() > 0


@pytest.mark.parametrize("klen", [31, 11])
def test_separable_blur_matches_xai_tpu(klen):
    x = np.random.RandomState(6).randn(2, 32, 40, 3).astype(np.float32)
    got = separable_blur(torch.from_numpy(x), klen, float(klen))
    assert got.shape == x.shape
    ref = np.asarray(jax_separable_blur(jnp.asarray(x), klen, float(klen)))
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-6)
