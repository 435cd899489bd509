"""xai_tpu_torch's LIME against xai_tpu's on the CPU.

The two packages draw their sample rows from different generators
(threefry vs torch), so every parity test injects the same numpy rows
into both (``rows=``); the weights are carried through ``save_params`` ->
``convert.from_jax.load_params``.  On CPU tensors the quickshift wrapper
runs its plain version and never counts a kernel launch.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn as nn

from xai_tpu.methods import lime as JL
from xai_tpu.models.common import ModelBundle as JaxBundle
from xai_tpu.models.common import ModelMeta as JaxMeta
from xai_tpu.ops.preprocess import normalize as jax_normalize
from xai_tpu.runners.common import build_bundle as jax_build_bundle
from xai_tpu.runners.common import save_params

from xai_tpu_torch.kernels import quickshift as kq
from xai_tpu_torch.methods import lime as TL
from xai_tpu_torch.models.common import ModelBundle, ModelMeta
from xai_tpu_torch.ops.preprocess import IMAGENET_MEAN, IMAGENET_STD
from xai_tpu_torch.ops.preprocess import normalize
from xai_tpu_torch.runners.common import build_bundle

from torch_one_thread import one_torch_thread  # noqa: F401 (autouse)

HW = 64
S = 200
PLANT_HW = 16


@pytest.fixture(autouse=True)
def _zero_counter():
    kq.quickshift_parents.launches = 0
    yield
    assert kq.quickshift_parents.launches == 0


@pytest.fixture(scope="module")
def twins(tmp_path_factory):
    jb = jax_build_bundle("TINY_R", seed=3)
    path = str(tmp_path_factory.mktemp("params") / "tiny_r.npz")
    save_params(jb.params, path)
    return jb, build_bundle("TINY_R", path, device="cpu")


def _images():
    """A noise image and a blocky one (8x8 colour blocks plus jitter)."""
    rs = np.random.RandomState(1)
    blocks = np.kron(rs.rand(8, 8, 3), np.ones((HW // 8, HW // 8, 1)))
    blocks = np.clip(blocks + 0.05 * rs.rand(HW, HW, 3), 0, 1)
    return np.stack([rs.rand(HW, HW, 3), blocks]).astype(np.float32)


def _rows(imgs, seed=0, s=S):
    """[B, S, F] rows the reference way: random bits over each image's
    segments, zeros past its count, row 0 all-on (lime_image.py:175)."""
    counts = [JL.lime_segments(im)[1] for im in imgs]
    rs = np.random.RandomState(seed)
    rows = np.zeros((len(imgs), s, max(counts)), np.int8)
    for i, n in enumerate(counts):
        rows[i, :, :n] = rs.randint(0, 2, (s, n))
        rows[i, 0, :n] = 1
    return rows


def _select(coef, num_features=5):
    """The lime tail on host: top-|coef| positive segments."""
    chosen = np.zeros(len(coef), bool)
    for f in np.argsort(-np.abs(coef), kind="stable"):
        if coef[f] > 0 and chosen.sum() < num_features:
            chosen[f] = True
    return chosen


def _jax_imagenet(x):
    return jax_normalize(x, IMAGENET_MEAN, IMAGENET_STD)


def _torch_imagenet(x):
    return normalize(x, IMAGENET_MEAN, IMAGENET_STD)


@pytest.mark.parametrize("norm,hide_color", [
    (None, 0.0), ((_jax_imagenet, _torch_imagenet), 0.5)],
    ids=["raw", "normalized_hide_half"])
def test_lime_batch_matches_xai_tpu(twins, norm, hide_color):
    """The driver's form (raw [0, 1] images, hide colour 0) and the
    options' form (a channel-last normalize_input, hide colour 0.5)."""
    jb, tb = twins
    jnorm, tnorm = norm or (None, None)
    imgs = _images()
    rows = _rows(imgs)
    for im in imgs:
        jl, jn = JL.lime_segments(im)
        tl, tn = TL.lime_segments(im, device="cpu")
        assert jn == tn
        np.testing.assert_array_equal(tl, jl)
    keys = [jax.random.PRNGKey(0)] * 2
    jm, jc = JL.lime_batch(jb, imgs, keys, chunk=50, rows=rows,
                           return_coef=True, hide_color=hide_color,
                           normalize_input=jnorm)
    tm, tc = TL.lime_batch(tb, imgs, None, chunk=50, rows=rows,
                           return_coef=True, hide_color=hide_color,
                           normalize_input=tnorm, device="cpu")
    assert tm.dtype == np.float32 and tm.shape == (2, HW, HW)
    assert tc.shape == jc.shape == (2, TL._F_MAX)
    # float32 forwards in two libraries (XLA vs oneDNN) sum in other
    # orders (~1e-6 relative in the probabilities); the ridge keeps that
    # order of error: coefficients within 1e-4 of the largest
    assert np.max(np.abs(tc - jc)) <= 1e-4 * np.max(np.abs(jc))
    np.testing.assert_array_equal(tm, jm)
    assert tm.sum() > 0


class _Planted(nn.Module):
    """Logits (s, -s) with s the sum of the image over its top-left 6x6
    corner: the nn.Module twin of test_segment_methods.py's planted
    model."""

    def __init__(self):
        super().__init__()
        w = torch.zeros(3, PLANT_HW, PLANT_HW)
        w[:, :6, :6] = 1.0
        self.register_buffer("w", w)

    def forward(self, x):
        s = (x * self.w).sum(dim=(1, 2, 3))
        return torch.stack([s, -s], dim=1)


def _planted_bundles():
    wmap = np.zeros((PLANT_HW, PLANT_HW, 3), np.float32)
    wmap[:6, :6] = 1.0

    def apply(p, x):
        s = (x * jnp.asarray(wmap)).sum(axis=(1, 2, 3))
        return jnp.stack([s, -s], axis=1)

    jb = JaxBundle(meta=JaxMeta(name="planted", family="cnn",
                                img_hw=PLANT_HW, num_classes=2),
                   params=None, apply=apply)
    tb = ModelBundle(ModelMeta(name="planted", family="cnn", img_hw=PLANT_HW,
                               num_classes=2), _Planted())
    return jb, tb


def _structured_img(hw):
    yy, xx = np.mgrid[0:hw, 0:hw] / hw
    img = np.stack([np.sin(yy * 6) * 0.5 + 0.5,
                    np.cos(xx * 5) * 0.5 + 0.5,
                    (yy + xx) / 2], -1)
    return img.astype(np.float32)


def test_lime_planted_signal_matches_xai_tpu():
    jb, tb = _planted_bundles()
    img = _structured_img(PLANT_HW)
    rows = _rows(img[None])[0]
    ref = JL.lime(jb, img, jax.random.PRNGKey(0), chunk=20, rows=rows)
    got = TL.lime(tb, img, None, chunk=20, rows=rows, device="cpu")
    assert got.shape == (PLANT_HW, PLANT_HW)
    assert set(np.unique(got)) <= {0.0, 1.0}
    np.testing.assert_array_equal(got, ref)
    assert got[:6, :6].mean() > 0.5          # the signal corner is chosen

    # return_coef is the vector the mask derives from
    masks, coef = TL.lime_batch(tb, img[None], None, chunk=20,
                                rows=rows[None], return_coef=True,
                                device="cpu")
    labels, _ = TL.lime_segments(img, device="cpu")
    np.testing.assert_array_equal(masks[0] > 0, _select(coef[0])[labels])
    np.testing.assert_array_equal(masks[0], got)


def test_lime_single_matches_batch_row(twins):
    _, tb = twins
    imgs = _images()
    rows = _rows(imgs, seed=4, s=60)
    batch = TL.lime_batch(tb, imgs, None, chunk=25, rows=rows, device="cpu")
    for i in range(2):
        one = TL.lime(tb, imgs[i], None, chunk=25, rows=rows[i],
                      device="cpu")
        np.testing.assert_array_equal(one, batch[i])


def test_lime_generator_seed_fixes_the_mask(twins):
    _, tb = twins
    img = _images()[1]

    def run(seed):
        g = torch.Generator("cpu").manual_seed(seed)
        return TL.lime(tb, img, g, num_samples=60, chunk=30, device="cpu")

    first = run(7)
    np.testing.assert_array_equal(run(7), first)
    assert set(np.unique(first)) <= {0.0, 1.0}


def test_sample_rows_follow_lime_image():
    counts = torch.tensor([3, 600])         # the second overflows F_MAX
    gens = [torch.Generator("cpu").manual_seed(i) for i in range(2)]
    rows = TL.sample_rows(gens, counts, 50)
    assert rows.dtype == torch.int8 and rows.shape == (2, 50, TL._F_MAX)
    assert rows[0, :, 3:].abs().sum() == 0  # no draw past the count
    assert rows[0, 0].tolist() == [1, 1, 1] + [0] * (TL._F_MAX - 3)
    assert bool((rows[1, 0] == 1).all())
    assert set(rows.unique().tolist()) == {0, 1}


def test_weighted_ridge_matches_xai_tpu():
    rs = np.random.RandomState(1)
    X = rs.randint(0, 2, (60, 7)).astype(float)
    y = rs.rand(60)
    w = rs.rand(60) + 0.1
    got = TL._weighted_ridge(X, y, w, alpha=1.0)
    ref = JL._weighted_ridge(X, y, w, alpha=1.0)
    np.testing.assert_array_equal(got[0], ref[0])     # the same numpy ops
    assert got[1] == ref[1]


def test_lime_bf16_matches_xai_tpu_bf16(twins):
    """dtype=bf16 on both packages, the same injected rows: the bf16
    sweep of each package stays within the LIME bf16 contract (masks
    agreeing on > 80 % of pixels) of the other's and of float32."""
    jb, tb = twins
    img = _images()[1]
    rows = _rows(img[None], seed=5)[0]
    ref16 = JL.lime(jb, img, jax.random.PRNGKey(0), chunk=50, rows=rows,
                    dtype=jnp.bfloat16)
    got16 = TL.lime(tb, img, None, chunk=50, rows=rows,
                    dtype=torch.bfloat16, device="cpu")
    got32 = TL.lime(tb, img, None, chunk=50, rows=rows, device="cpu")
    assert got16.dtype == np.float32 and set(np.unique(got16)) <= {0., 1.}
    assert (got16 == ref16).mean() > 0.8
    assert (got16 == got32).mean() > 0.8
