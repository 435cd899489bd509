"""The perturbation battery of xai_tpu_torch against xai_tpu on TINY_R.

At 64 px the battery runs 64 reveal steps (65 curve points) in each of its
three passes (blur/ins, zeros/del, zeros/lerf).  The same carried weights,
the same input and the same numpy saliency go through both packages'
battery on the CPU; the batched battery
(``parallel/sharded_battery.py``) against xai_tpu's on a one-device mesh,
and against the per-image battery on TINY_R and a small ViT, on one
device and over a two-shard virtual mesh of the CPU.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xai_tpu.metrics import curves as JC
from xai_tpu.ops.blur import make_blur_fn as jax_make_blur_fn
from xai_tpu.ops.stats import entropy_bits as jax_entropy_bits
from xai_tpu.parallel import sharded_battery as JSB
from xai_tpu.parallel.mesh import make_mesh
from xai_tpu.runners.common import build_bundle as jax_build_bundle
from xai_tpu.runners.common import save_params

from xai_tpu_torch.metrics import curves as TC
from xai_tpu_torch.models import vit as tvit
from xai_tpu_torch.models.common import ModelBundle, ModelMeta
from xai_tpu_torch.ops.blur import make_blur_fn
from xai_tpu_torch.ops.stats import entropy_bits
from xai_tpu_torch.parallel import sharded_battery as TSB
from xai_tpu_torch.parallel.mesh import make_mesh as torch_make_mesh
from xai_tpu_torch.runners.common import build_bundle

from torch_one_thread import one_torch_thread  # noqa: F401 (autouse)

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
    # the port's engine on a batch of one, as its per-image battery runs it
    xc = torch.from_numpy(x.transpose(2, 0, 1).copy())[None]
    tins, tdel, tlerf, tt = TC._battery(
        tb.apply, make_blur_fn(31, 31.0), xc,
        torch.from_numpy(desc.reshape(1, HW, HW)),
        torch.from_numpy(asc.reshape(1, HW, HW)), N_STEPS, CHUNK,
        None if target is None else torch.tensor([target]))
    assert tt.tolist() == [int(jt)]
    for jpass, tpass in ((jins, tins), (jdel, tdel), (jlerf, tlerf)):
        for jc, tc in zip(jpass, tpass):
            assert tc.shape == (1, N_STEPS + 1)
            # probabilities and entropies through the same float32 model
            # in two libraries: ~1e-6 relative
            np.testing.assert_allclose(tc[0].numpy(), np.asarray(jc),
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


def _batch(b=3, seed=5):
    rs = np.random.RandomState(seed)
    return (rs.randn(b, HW, HW, 3).astype(np.float32),
            rs.rand(b, HW, HW).astype(np.float32))


def test_batched_curves_match_xai_tpu(twins):
    """Three images, each read at its own target (two forced away from
    the argmax), against xai_tpu's vmapped batched_curves; the port's
    batched battery (``parallel/sharded_battery.py``) runs this engine."""
    jb, tb, _, _ = twins
    xs, sals = _batch()
    finishes = np.random.RandomState(6).rand(*xs.shape).astype(np.float32)
    flips = np.stack([JC.pixel_flip_steps(s, HW) for s in sals])
    targets = np.array([3, 17, 500])
    ref = JSB.batched_curves(jb.apply, jb.params, jnp.asarray(xs),
                             jnp.asarray(finishes), jnp.asarray(flips),
                             jnp.asarray(targets), N_STEPS, CHUNK)

    def nchw(a):
        return torch.from_numpy(a.transpose(0, 3, 1, 2).copy())

    got = TC.batched_curves(tb.apply, nchw(xs), nchw(finishes),
                             torch.from_numpy(flips.reshape(-1, HW, HW)),
                             torch.from_numpy(targets), N_STEPS, CHUNK)
    for r, g in zip(ref, got):
        assert g.shape == (3, N_STEPS + 1)
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-4,
                                   atol=1e-6)


@pytest.mark.parametrize("targets", [None, [3, 17, 500]],
                         ids=["argmax", "explicit"])
def test_sharded_battery_scores_match_xai_tpu(twins, targets):
    jb, tb, _, _ = twins
    xs, sals = _batch()
    ref = JSB.sharded_battery_scores(jb, make_mesh(1), xs, sals,
                                     jax_make_blur_fn(31, 31.0), chunk=CHUNK,
                                     targets=targets)
    got = TSB.sharded_battery_scores(tb, torch.from_numpy(xs), sals,
                                     make_blur_fn(31, 31.0), chunk=CHUNK,
                                     targets=targets)
    assert len(got) == len(ref) == 3
    for g, r in zip(got, ref):
        assert list(g) == list(r)
        for k in r:
            assert abs(g[k] - r[k]) < 2e-3, (k, g[k], r[k])


def test_sharded_battery_equals_run_battery(twins):
    """The batched battery gives each image the scores of the per-image
    battery (the driver's tail path), on TINY_R and a two-block ViT, on
    the bundle's device alone (both images in one battery) and over a
    two-shard virtual mesh of the CPU (an image a shard)."""
    _, tb, _, _ = twins
    vit = ModelBundle(
        ModelMeta(name="v", family="vit", img_hw=HW, num_classes=16),
        tvit.init_random(tvit.VisionTransformer(tvit.ViTConfig(
            patch=16, embed_dim=32, depth=2, num_heads=4, mlp_ratio=2.0,
            num_classes=16, img_hw=HW)), seed=4))
    xs, sals = _batch(2, seed=8)
    targets = [4, 9]
    for bundle in (tb, vit):
        for mesh in (None, torch_make_mesh(devices=[torch.device("cpu")] * 2)):
            got = TSB.sharded_battery_scores(
                bundle, torch.from_numpy(xs), sals, make_blur_fn(31, 31.0),
                chunk=CHUNK, targets=targets, mesh=mesh)
            for i in range(2):
                want = TC.run_battery(bundle.apply, torch.from_numpy(xs[i]),
                                      sals[i], make_blur_fn(31, 31.0),
                                      chunk=CHUNK, target=targets[i])
                for k in want:
                    assert abs(got[i][k] - want[k]) < 1e-5, (
                        bundle.meta.name, mesh, k, got[i][k], want[k])
