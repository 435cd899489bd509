"""RISE, AGI and the PGD attack of xai_tpu_torch against xai_tpu, on the
CPU.

TINY_R twins from one ``.npz``.  RISE gets the same injected masks in both
packages, and ``masks_from_grid`` the Bernoulli grids and crop offsets
that xai_tpu's ``generate_masks`` draws from its key.  AGI runs at 32 px:
at 64 px the zero-bias random weights put ReLU inputs within float32
rounding of zero, and the sign of a softmax gradient near zero falls
either way between XLA and oneDNN.  Tolerance 1e-4 of the reference's
largest |value|.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xai_tpu.methods import adversarial as JADV
from xai_tpu.methods import agi as JA
from xai_tpu.methods import rise as JR
from xai_tpu.runners.common import build_bundle as jax_build_bundle
from xai_tpu.runners.common import save_params

from xai_tpu_torch.methods import adversarial as ADV
from xai_tpu_torch.methods import agi as A
from xai_tpu_torch.methods import rise as R
from xai_tpu_torch.runners.common import build_bundle

from torch_one_thread import one_torch_thread  # noqa: F401 (autouse)


@pytest.fixture(scope="module")
def twins(tmp_path_factory):
    jb = jax_build_bundle("TINY_R", seed=5)
    path = str(tmp_path_factory.mktemp("params") / "tiny_r.npz")
    save_params(jb.params, path)
    return jb, build_bundle("TINY_R", path, device="cpu")


def _rel(got, ref):
    ref = np.asarray(ref)
    return np.max(np.abs(np.asarray(got) - ref)) / np.max(np.abs(ref))


def _jax_grid(key, n, s, p1, hw):
    """generate_masks's two draws from ``key`` (xai_tpu/methods/rise.py)."""
    k1, k2 = jax.random.split(key)
    grid = (jax.random.uniform(k1, (n, s, s)) < p1).astype(jnp.float32)
    offs = jax.random.randint(k2, (n, 2), 0, int(np.ceil(hw / s)))
    return np.array(grid), np.array(offs)


@pytest.mark.parametrize("hw,s", [(64, 8), (224, 8), (50, 6)])
def test_masks_from_grid_matches_generate_masks(hw, s):
    key = jax.random.PRNGKey(hw)
    ref = np.asarray(JR.generate_masks(key, 40, s, 0.5, hw))
    grid, offs = _jax_grid(key, 40, s, 0.5, hw)
    got = R.masks_from_grid(torch.from_numpy(grid),
                            torch.from_numpy(offs).long(), hw).numpy()
    assert got.shape == ref.shape == (40, hw, hw)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)


def test_generate_masks_draws_from_the_generator():
    def draw(seed):
        return R.generate_masks(torch.Generator("cpu").manual_seed(seed),
                                20, 8, 0.5, 32)

    m = draw(1)
    assert m.shape == (20, 32, 32) and m.min() >= 0 and m.max() <= 1
    assert torch.equal(m, draw(1)) and not torch.equal(m, draw(2))
    grid, offs = R.draw_grid(torch.Generator("cpu").manual_seed(1), 20, 8,
                             0.5, 32)
    assert torch.equal(m, R.masks_from_grid(grid, offs, 32))


@pytest.mark.parametrize("raw_scores", [False, True],
                         ids=["softmax", "raw"])
def test_rise_matches_xai_tpu(twins, raw_scores):
    """120 injected masks in chunks of 50: xai_tpu and the port step the
    chunk down to 40."""
    jb, tb = twins
    hw = 64
    x = np.random.RandomState(2).randn(hw, hw, 3).astype(np.float32)
    target = int(np.argmax(np.asarray(jb.apply(jb.params,
                                               jnp.asarray(x)[None]))[0]))
    masks = np.array(JR.generate_masks(jax.random.PRNGKey(1), 120, 8, 0.5,
                                        hw))
    ref = JR.rise(jb, x, target, None, masks=masks, raw_scores=raw_scores)
    got = R.rise(tb, torch.from_numpy(x), target, masks=masks,
                 raw_scores=raw_scores)
    assert got.shape == ref.shape == (hw, hw)
    assert _rel(got, ref) <= 1e-4


def test_rise_needs_a_generator_or_masks(twins):
    _, tb = twins
    with pytest.raises(ValueError, match="generator"):
        R.rise(tb, torch.zeros(32, 32, 3), 0)


def _image(hw=32, seed=5):
    return np.random.RandomState(seed).rand(hw, hw, 3).astype(np.float32)


@pytest.mark.parametrize("selected", [[0], [0, 7, 500]],
                         ids=["topk1", "three_targets"])
def test_agi_raw_matches_xai_tpu(twins, selected):
    jb, tb = twins
    img = _image()
    ref = JA.agi_raw(jb, img, selected)
    got = A.agi_raw(tb, img, selected)
    assert got.shape == ref.shape == (32, 32, 3)
    assert _rel(got, ref) <= 1e-4


def test_agi_matches_xai_tpu(twins):
    """The driver's configuration: topk=1, then the [80, 99] percentile
    band."""
    jb, tb = twins
    img = _image()
    ref = JA.agi(jb, img)
    got = A.agi(tb, img).numpy()
    assert got.shape == ref.shape == (32, 32)
    assert np.isfinite(ref).all()
    assert _rel(got, ref) <= 1e-4


@pytest.mark.parametrize("hw", [32, 224])
def test_agi_post_matches_jnp_percentile(hw):
    """torch.quantile's linear interpolation is jnp.percentile's."""
    raw = np.random.RandomState(hw).randn(hw, hw, 3).astype(np.float32)
    ref = np.asarray(JA._agi_post(jnp.asarray(raw)))
    got = A._agi_post(torch.from_numpy(raw).permute(2, 0, 1)[None])[0]
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-6)


def test_agi_of_the_attacked_class_is_nan(twins):
    """An image predicted as the only attacked class is not attacked: its
    deltas are zero and its map 0/0, as in xai_tpu."""
    _, tb = twins
    img = _image()
    pred = int(A._norm_apply(tb, torch.from_numpy(img).permute(2, 0, 1)[None]
                             ).argmax())
    raw = A.agi_raw(tb, img, [pred])
    assert not raw.any()
    assert torch.isnan(A._agi_post(raw.permute(2, 0, 1)[None])).all()


def test_agi_batch_matches_per_image(twins):
    """agi_batch of three images against agi one image at a time; bf16
    runs its attacks on the bf16 copy and keeps the float32 initial
    prediction."""
    _, tb = twins
    imgs = np.stack([_image(seed=s) for s in (5, 6, 7)])
    got = A.agi_batch(tb, imgs)
    for i in range(3):
        want = A.agi(tb, imgs[i])
        np.testing.assert_allclose(got[i].numpy(), want.numpy(), atol=1e-5,
                                   rtol=1e-4)
    low = A.agi_batch(tb, imgs, dtype=torch.bfloat16)
    assert low.dtype == torch.float32 and low.shape == (3, 32, 32)


def test_pgd_attack_matches_xai_tpu(twins):
    jb, tb = twins
    imgs = np.stack([_image(seed=s) for s in (1, 2)])
    labels = np.array([3, 9])
    ref = np.asarray(JADV.pgd_attack(jb.apply, jb.params, jnp.asarray(imgs),
                                     jnp.asarray(labels), 0.05, 4))
    got = ADV.pgd_attack(tb, torch.from_numpy(imgs), labels, 0.05, 4).numpy()
    assert got.shape == ref.shape
    # each step moves a pixel by +-alpha: a sign that differs shows as a
    # 2 * alpha difference at that pixel
    assert np.abs(got - ref).max() <= 1e-6
    assert np.abs(got - imgs).max() <= 0.05 + 1e-6
