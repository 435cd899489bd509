"""GradientShap, FeatureAblation, Occlusion and Shapley sampling of
xai_tpu_torch against xai_tpu, on the CPU.

TINY_R twins from one ``.npz`` at 64 px.  The random draws (GradientShap's
baseline, alphas and baseline indices; Shapley's permutations) are
injected into both packages, since JAX's and torch's generators never draw
alike.  xai_tpu's patch mask needs the image size to be a multiple of the
patch grid, so FeatureAblation and Shapley run a 4x4 grid (16 px patches)
here.  Tolerance 1e-4 of the reference's largest |value| for the methods
that subtract nearby logits, 1e-5 for GradientShap.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xai_tpu.methods import ablation as JAB
from xai_tpu.runners.common import build_bundle as jax_build_bundle
from xai_tpu.runners.common import save_params

from xai_tpu_torch.methods import ablation as AB
from xai_tpu_torch.runners.common import build_bundle

from torch_one_thread import one_torch_thread  # noqa: F401 (autouse)

HW = 64


@pytest.fixture(scope="module")
def twins(tmp_path_factory):
    jb = jax_build_bundle("TINY_R", seed=5)
    path = str(tmp_path_factory.mktemp("params") / "tiny_r.npz")
    save_params(jb.params, path)
    tb = build_bundle("TINY_R", path, device="cpu")
    x = np.random.RandomState(2).randn(HW, HW, 3).astype(np.float32)
    target = int(np.argmax(np.asarray(jb.apply(jb.params,
                                               jnp.asarray(x)[None]))[0]))
    return jb, tb, x, target


def _rel(got, ref):
    ref = np.asarray(ref)
    return np.max(np.abs(np.asarray(got) - ref)) / np.max(np.abs(ref))


@pytest.mark.parametrize("n_base", [1, 3])
def test_gradient_shap_matches_xai_tpu(twins, n_base):
    jb, tb, x, target = twins
    rs = np.random.RandomState(3 + n_base)
    baselines = rs.randn(n_base, HW, HW, 3).astype(np.float32)
    alphas = rs.rand(5).astype(np.float32)
    base_idx = rs.randint(0, n_base, 5)
    ref = JAB.gradient_shap(jb, x, target, jax.random.PRNGKey(0),
                            baselines=baselines, alphas=alphas,
                            base_idx=base_idx)
    got = AB.gradient_shap(tb, torch.from_numpy(x), target, None,
                           baselines=baselines, alphas=alphas,
                           base_idx=base_idx)
    assert got.shape == ref.shape == (HW, HW, 3)
    assert _rel(got, ref) <= 1e-5


def test_feature_ablation_matches_xai_tpu(twins):
    jb, tb, x, target = twins
    ref = JAB.feature_ablation(jb, x, target, num_patches=4)
    got = AB.feature_ablation(tb, torch.from_numpy(x), target, num_patches=4)
    assert got.shape == ref.shape == (HW, HW, 3)
    assert _rel(got, ref) <= 1e-4


@pytest.mark.parametrize("window,stride", [(64, 32), (24, 8), (16, 12)])
def test_occlusion_matches_xai_tpu(twins, window, stride):
    """The driver's window and stride (one position at 64 px), overlapping
    windows, and a stride that leaves the last pixels uncovered."""
    jb, tb, x, target = twins
    ref = JAB.occlusion(jb, x, target, window=window, stride=stride)
    got = AB.occlusion(tb, torch.from_numpy(x), target, window=window,
                       stride=stride)
    assert got.shape == ref.shape == (HW, HW, 3)
    assert _rel(got, ref) <= 1e-4


def test_shapley_matches_xai_tpu(twins):
    """Injected permutations; 5 of them over 16 groups (xai_tpu pads each
    permutation's 17 coalitions to a multiple of its chunk; the port runs
    only the 17)."""
    jb, tb, x, target = twins
    rs = np.random.RandomState(6)
    perms = np.stack([rs.permutation(16) for _ in range(5)])
    ref = JAB.shapley_sampling(jb, x, target, None, num_patches=4,
                               n_samples=5, chunk=7, perms=perms)
    got = AB.shapley_sampling(tb, torch.from_numpy(x), target, None,
                              num_patches=4, n_samples=5, chunk=7,
                              perms=perms)
    assert got.shape == ref.shape == (HW, HW, 3)
    assert _rel(got, ref) <= 1e-4


@pytest.mark.parametrize("hw,n", [(224, 14), (64, 4), (32, 8)])
def test_patch_mask_matches_xai_tpu(hw, n):
    ref = np.asarray(JAB.patch_mask(hw, n))
    np.testing.assert_array_equal(AB.patch_mask(hw, n).numpy(), ref)


def test_patch_mask_covers_sizes_the_grid_does_not_divide():
    """TINY_R's 64 px with the driver's 14x14 grid: xai_tpu's mask is
    56x56 and its driver cannot run fa or shap there; the port's patches
    are 4 or 5 px, every id once, in row-major order."""
    m = AB.patch_mask(64, 14).numpy()
    assert m.shape == (64, 64)
    assert np.array_equal(np.unique(m), np.arange(196))
    sizes = np.bincount(m.ravel())
    assert set(sizes) <= {16, 20, 25}
    assert np.all(np.diff(m[0]) >= 0) and np.all(np.diff(m[:, 0]) >= 0)


def test_draws_come_from_the_generator(twins):
    """gs and shap draw from the image's generator: the same seed gives
    the same map, another seed another; without a generator or the draws
    they raise."""
    _, tb, x, target = twins
    xt = torch.from_numpy(x)

    def run(fn, seed, **kw):
        return fn(tb, xt, target, torch.Generator("cpu").manual_seed(seed),
                  **kw)

    for fn, kw in ((AB.gradient_shap, {}),
                   (AB.shapley_sampling, {"num_patches": 4,
                                          "n_samples": 2})):
        assert torch.equal(run(fn, 3, **kw), run(fn, 3, **kw))
        assert not torch.equal(run(fn, 3, **kw), run(fn, 4, **kw))
        with pytest.raises(ValueError, match="generator"):
            fn(tb, xt, target, None)
