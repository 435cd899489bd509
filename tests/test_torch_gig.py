"""Guided IG of xai_tpu_torch against xai_tpu, on the CPU.

TINY_R twins from one ``.npz`` at 32 px: at 64 px the zero-bias random
weights put ReLU inputs within float32 rounding of zero, and a feature on
the edge of the |gradient| quantile falls either way between XLA and
oneDNN.  Tolerance 1e-4 of the reference's largest |value|, at 8 steps.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xai_tpu.methods import gig as JGI
from xai_tpu.runners.common import build_bundle as jax_build_bundle
from xai_tpu.runners.common import save_params

from xai_tpu_torch.methods import gig as GI
from xai_tpu_torch.runners.common import build_bundle

from torch_one_thread import one_torch_thread  # noqa: F401 (autouse)

HW = 32
STEPS = 8


@pytest.fixture(scope="module")
def twins(tmp_path_factory):
    jb = jax_build_bundle("TINY_R", seed=5)
    path = str(tmp_path_factory.mktemp("params") / "tiny_r.npz")
    save_params(jb.params, path)
    tb = build_bundle("TINY_R", path, device="cpu")
    xs = np.random.RandomState(2).randn(3, HW, HW, 3).astype(np.float32)
    targets = np.array(jnp.argmax(jb.apply(jb.params, jnp.asarray(xs)),
                                    axis=-1))
    return jb, tb, xs, targets


def _rel(got, ref):
    ref = np.asarray(ref)
    return np.max(np.abs(np.asarray(got) - ref)) / np.max(np.abs(ref))


@pytest.mark.parametrize("case", ["zero_baseline", "image_baseline",
                                  "max_dist"])
def test_guided_ig_matches_xai_tpu(twins, case):
    """The driver's configuration, a per-pixel baseline, and max_dist 0.3
    (alpha windows inside [0, 1]).  The baseline case runs 4 steps: at 8,
    a discrete choice of a later step (which features the search moves)
    falls the other way between the two libraries, and two pixels
    differ."""
    jb, tb, xs, targets = twins
    x, target = xs[0], int(targets[0])
    kw = {"steps": STEPS}
    if case == "image_baseline":
        kw = {"steps": 4, "baseline": 0.3 * np.random.RandomState(8).randn(
            HW, HW, 3).astype(np.float32)}
    if case == "max_dist":
        kw["max_dist"] = 0.3
    ref = JGI.guided_ig(jb, x, target, **kw)
    got = GI.guided_ig(tb, torch.from_numpy(x), target, **kw)
    assert got.shape == ref.shape == (HW, HW, 3)
    assert _rel(got, ref) <= 1e-4


def test_guided_ig_batch_matches_per_image(twins):
    """Each image's inner search runs to its own exit inside the batch."""
    _, tb, xs, targets = twins
    x = torch.from_numpy(xs).permute(0, 3, 1, 2)
    got = GI.guided_ig_batch(tb, x, torch.from_numpy(targets).long(), STEPS)
    for i in range(3):
        want = GI.guided_ig(tb, torch.from_numpy(xs[i]), int(targets[i]),
                            steps=STEPS)
        np.testing.assert_allclose(got[i].permute(1, 2, 0).numpy(),
                                   want.numpy(), atol=1e-6, rtol=1e-5)


def test_guided_ig_of_the_baseline_is_zero(twins):
    _, tb, xs, _ = twins
    base = torch.from_numpy(xs[1])
    got = GI.guided_ig(tb, base, 3, steps=STEPS, baseline=base)
    assert got.shape == (HW, HW, 3) and not got.any()


@pytest.mark.parametrize("k", [0, 1536, 3071])
def test_kthvalue_is_xai_tpus_order_statistic(k):
    """torch.kthvalue(a, k + 1) against xai_tpu's bit-pattern search for
    the k-th smallest non-negative float, inf and ties included."""
    rs = np.random.RandomState(k)
    a = np.abs(rs.randn(3072)).astype(np.float32)
    a[rs.randint(0, 3072, 700)] = np.inf
    a[:40] = a[40]
    ref = float(JGI._kth_smallest_nonneg(jnp.asarray(a), k))
    got = float(torch.kthvalue(torch.from_numpy(a), k + 1).values)
    assert got == ref == float(np.sort(a)[k])
