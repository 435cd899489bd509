"""xai_tpu_torch's quickshift against xai_tpu's on the CPU.

On a CPU tensor ``kernels.quickshift.quickshift_parents`` runs its plain
version, ``ops.quickshift.parents_plain``: the Pallas kernel's two loops
over the window offsets.  These tests hold it against the XLA form
``_quickshift_device_b`` and the Pallas kernel in interpret mode.  The
CUDA kernel is held against the plain version on the card by
chip_smoke.py (parents bit-exact).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xai_tpu.kernels.quickshift_pallas import quickshift_parents_pallas
from xai_tpu.ops import quickshift_jax as JQ

from xai_tpu_torch.kernels import quickshift as kq
from xai_tpu_torch.ops import quickshift as TQ

# LIME's configuration (kernel_size 4, max_dist 200): w = wd = 12
W12, INV2S2, MAX_D2 = 12, 1.0 / 32.0, 40000.0


@pytest.fixture(autouse=True)
def _zero_counter():
    kq.quickshift_parents.launches = 0
    yield
    # a CPU call takes the plain version and never counts a launch
    assert kq.quickshift_parents.launches == 0


def _gradient_fixture():
    """tests/test_kernels.py's 48 px fixture: a smooth gradient plus
    jitter, and a darker noisier copy."""
    rs = np.random.RandomState(0)
    h = 48
    yy, xx = np.mgrid[0:h, 0:h] / h
    img = np.stack([yy, xx, yy * xx], -1).astype(np.float32)
    img += 0.05 * rs.rand(h, h, 3).astype(np.float32)
    return np.stack(
        [img, np.clip(img * 0.7 + 0.2 * rs.rand(h, h, 3), 0, 1)],
    ).astype(np.float32)


def test_rgb2lab_matches_jax():
    x = np.random.RandomState(0).rand(2, 32, 40, 3).astype(np.float32)
    # both branches and the ends, in every channel
    x[0, 0, :4] = np.asarray([0.0, 0.01, 0.04045, 1.0])[:, None]
    ref = np.asarray(JQ.rgb2lab(jnp.asarray(x)))
    got = TQ.rgb2lab(torch.from_numpy(x)).numpy()
    assert got.dtype == np.float32
    # t ** (1/3) against JAX's cbrt, each within an ulp or two of the cube
    # root, then scaled by up to 500: 6.1e-5 at worst on noise
    assert np.max(np.abs(got - ref)) < 1e-4


@pytest.mark.parametrize("shape,seed", [((2, 64, 64), 1), ((1, 40, 56), 2)],
                         ids=["2x64sq", "40x56"])
def test_parents_plain_matches_xla_at_lime_window(shape, seed):
    """Noise images at LIME's w = wd = 12: equal parents.  (Smooth images
    have density near-ties; two float sums in another order can flip a
    parent there, so noise is the exact fixture.)"""
    x = np.random.RandomState(seed).rand(*shape, 3).astype(np.float32)
    ref = np.asarray(JQ._quickshift_device_b(
        jnp.asarray(x), W12, W12, jnp.float32(0.2), jnp.float32(INV2S2),
        jnp.float32(MAX_D2)))
    got = kq.quickshift_parents(torch.from_numpy(x), INV2S2, MAX_D2, 0.2,
                                w=W12, wd=W12)
    assert got.dtype == torch.int32 and tuple(got.shape) == shape
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("form", ["xla", "pallas_interpret"])
def test_parents_plain_matches_jax_on_kernel_fixture(form):
    imgs = _gradient_fixture()
    w, wd = 6, 6
    inv2s2, maxd2 = np.float32(1 / 8.0), np.float32(100.0)
    if form == "xla":
        ref = JQ._quickshift_device_b(jnp.asarray(imgs), w, wd,
                                      jnp.float32(0.2), inv2s2, maxd2)
    else:
        ref = quickshift_parents_pallas(jnp.asarray(imgs), inv2s2, maxd2,
                                        jnp.float32(0.2), w=w, wd=wd,
                                        interpret=True)
    got = TQ.parents_plain(torch.from_numpy(imgs), w, wd, 0.2, float(inv2s2),
                           float(maxd2))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_parents_radius_excludes_offsets():
    """wd < w: a parent lies within the Chebyshev radius wd."""
    x = np.random.RandomState(4).rand(1, 24, 30, 3).astype(np.float32)
    w, wd = 6, 2
    ref = np.asarray(JQ._quickshift_device_b(
        jnp.asarray(x), w, wd, jnp.float32(0.2), jnp.float32(1 / 8.0),
        jnp.float32(400.0)))
    got = TQ.parents_plain(torch.from_numpy(x), w, wd, 0.2, 1 / 8.0,
                           400.0).numpy()
    np.testing.assert_array_equal(got, ref)
    idx = np.arange(24 * 30).reshape(24, 30)
    dy = got[0] // 30 - idx // 30
    dx = got[0] % 30 - idx % 30
    assert np.max(np.maximum(np.abs(dy), np.abs(dx))) <= wd
    assert (got[0] != idx).any()


def test_labels_and_counts_match_jax():
    rs = np.random.RandomState(0)
    cases = []
    for _ in range(3):                # parent forests, as xai_tpu's test
        n = 24 * 24
        parent = np.arange(n, dtype=np.int32)
        for i in range(n - 1):
            if rs.rand() < 0.8:
                parent[i] = rs.randint(i + 1, n)
        cases.append(parent.reshape(24, 24))
    real = TQ.parents_plain(torch.from_numpy(
        rs.rand(1, 24, 24, 3).astype(np.float32)), 6, 2, 0.2, 1 / 8.0, 64.0)
    cases.append(real[0].numpy())
    batch = np.stack(cases)
    ref_l, ref_c = JQ.parents_to_labels_batch(jnp.asarray(batch))
    got_l, got_c = TQ.parents_to_labels_batch(torch.from_numpy(batch))
    assert got_l.dtype == torch.int32
    np.testing.assert_array_equal(got_l.numpy(), np.asarray(ref_l))
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(ref_c))
    for parent, labels in zip(cases, got_l.numpy()):
        np.testing.assert_array_equal(
            labels.reshape(24, 24), TQ._compact(parent.reshape(-1), 24, 24))
        np.testing.assert_array_equal(
            labels.reshape(24, 24), JQ._compact(parent.reshape(-1), 24, 24))


def test_quickshift_device_matches_jax():
    img = np.random.RandomState(3).rand(64, 64, 3).astype(np.float32)
    ref = JQ.quickshift_device(img, 0.2, 4.0, 200.0)
    got = TQ.quickshift_device(img, 0.2, 4.0, 200.0, device="cpu")
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, ref)
    # a CPU tensor runs where it lies
    np.testing.assert_array_equal(
        TQ.quickshift_device(torch.from_numpy(img), 0.2, 4.0, 200.0), ref)
    batch = TQ.quickshift_device_batch(np.stack([img, img[::-1]]),
                                       device="cpu")
    np.testing.assert_array_equal(batch[0], ref)
    np.testing.assert_array_equal(
        batch[1], JQ.quickshift_device(img[::-1].copy(), 0.2, 4.0, 200.0))


def test_kernel_wrapper_rejects_what_it_cannot_run():
    with pytest.raises(ValueError, match="CUDA"):
        kq.parents_density(torch.zeros(1, 3, 8, 8), W12, W12, INV2S2,
                           MAX_D2)
    with pytest.raises(ValueError, match="unsupported device"):
        kq.quickshift_parents(torch.zeros(1, 8, 8, 3, device="meta"),
                              INV2S2, MAX_D2, 0.2, w=W12, wd=W12)


# windows outside 0 <= wd <= w <= MAX_W: refused before any device check,
# and before a library is built or loaded
@pytest.mark.parametrize("w,wd", [(0, 0), (kq.MAX_W + 1, 4), (6, 7),
                                  (6, -1)])
def test_kernel_wrapper_rejects_windows_it_does_not_take(w, wd,
                                                        monkeypatch):
    built = []
    monkeypatch.setattr(kq, "_entry", lambda: built.append(1))
    with pytest.raises(ValueError, match="MAX_W|<= w"):
        kq.parents_density(torch.zeros(1, 3, 8, 8), w, wd, INV2S2, MAX_D2)
    assert not built
