"""The perturbation battery of xai_tpu_torch against xai_tpu on TINY_R.

At 64 px the battery runs 64 reveal steps (65 curve points) in each of its
three passes (blur/ins, zeros/del, zeros/lerf).  The same carried weights,
the same input and the same numpy saliency go through both packages'
battery on the CPU.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xai_tpu.metrics import curves as JC
from xai_tpu.ops.blur import make_blur_fn as jax_make_blur_fn
from xai_tpu.ops.stats import entropy_bits as jax_entropy_bits
from xai_tpu.runners.common import build_bundle as jax_build_bundle
from xai_tpu.runners.common import save_params

from xai_tpu_torch.metrics import curves as TC
from xai_tpu_torch.ops.blur import make_blur_fn
from xai_tpu_torch.ops.stats import entropy_bits
from xai_tpu_torch.runners.common import build_bundle

HW = 64
N_STEPS = HW * HW // HW
CHUNK = 45          # the driver's chunk: 65 points = 45 + a ragged 20


@pytest.fixture(scope="module")
def twins(tmp_path_factory):
    jb = jax_build_bundle("TINY_R", seed=9)
    path = str(tmp_path_factory.mktemp("params") / "tiny_r.npz")
    save_params(jb.params, path)
    tb = build_bundle("TINY_R", path, device="cpu")
    rs = np.random.RandomState(3)
    x = rs.randn(HW, HW, 3).astype(np.float32)
    sal = rs.rand(HW, HW).astype(np.float32)
    return jb, tb, x, sal


def test_pixel_flip_steps_is_xai_tpus():
    rs = np.random.RandomState(0)
    sal = rs.randint(0, 5, size=(16, 16)).astype(np.float32)   # many ties
    for desc in (True, False):
        assert np.array_equal(TC.pixel_flip_steps(sal, 16, desc),
                              JC.pixel_flip_steps(sal, 16, desc))


def test_entropy_bits_matches():
    p = np.random.RandomState(1).dirichlet(np.ones(10), size=4)
    p[0, :] = 0.0
    p[0, 3] = 1.0                      # the clamp at 1e-12
    p = p.astype(np.float32)
    np.testing.assert_allclose(entropy_bits(torch.from_numpy(p)).numpy(),
                               np.asarray(jax_entropy_bits(jnp.asarray(p))),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("target", [None, 3], ids=["argmax", "explicit"])
def test_curves_match(twins, target):
    jb, tb, x, sal = twins
    desc = JC.pixel_flip_steps(sal, HW, True)
    asc = JC.pixel_flip_steps(sal, HW, False)
    t = -1 if target is None else target
    jins, jdel, jlerf, jt = JC._battery_device(
        jb.apply, jax_make_blur_fn(31, 31.0), jb.params, jnp.asarray(x),
        jnp.asarray(desc), jnp.asarray(asc), N_STEPS, CHUNK, t)
    xc = torch.from_numpy(x.transpose(2, 0, 1).copy())
    tins, tdel, tlerf, tt = TC._battery(
        tb.apply, make_blur_fn(31, 31.0), xc,
        torch.from_numpy(desc.reshape(HW, HW)),
        torch.from_numpy(asc.reshape(HW, HW)), N_STEPS, CHUNK, t)
    assert tt == int(jt)
    for jpass, tpass in ((jins, tins), (jdel, tdel), (jlerf, tlerf)):
        for jc, tc in zip(jpass, tpass):
            assert tc.shape == (N_STEPS + 1,)
            # probabilities and entropies through the same float32 model
            # in two libraries: ~1e-6 relative
            np.testing.assert_allclose(tc.numpy(), np.asarray(jc),
                                       rtol=1e-4, atol=1e-6)


def test_run_battery_scores_match(twins):
    jb, tb, x, sal = twins
    ref = JC.run_battery(jb.apply, jb.params, x, sal,
                         jax_make_blur_fn(31, 31.0), chunk=CHUNK)
    got = TC.run_battery(tb.apply, torch.from_numpy(x), sal,
                         make_blur_fn(31, 31.0), chunk=CHUNK)
    assert list(got) == list(ref)                  # same keys, same order
    for k in ref:
        # the tolerance of tests/test_driver_csv_parity.py
        assert abs(got[k] - ref[k]) < 2e-3, (k, got[k], ref[k])
        assert np.isfinite(got[k])
