"""Gradient-path attributions of xai_tpu_torch against xai_tpu on TINY_R.

The same carried weights and the same numpy input go through
xai_tpu.methods.gradient and its port, on the CPU.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xai_tpu.methods import gradient as JG
from xai_tpu.runners.common import build_bundle as jax_build_bundle
from xai_tpu.runners.common import save_params

from xai_tpu_torch.methods import gradient as TG
from xai_tpu_torch.runners.common import build_bundle

HW = 64
STEPS = 8

METHODS = {
    "grad": (lambda b, x, t: JG.grad(b, x, t),
             lambda b, x, t: TG.grad(b, x, t)),
    "inp_x_grad": (lambda b, x, t: JG.inp_x_grad(b, x, t),
                   lambda b, x, t: TG.inp_x_grad(b, x, t)),
    "ig": (lambda b, x, t: JG.ig(b, x, t, steps=STEPS),
           lambda b, x, t: TG.ig(b, x, t, steps=STEPS)),
    "lig": (lambda b, x, t: JG.lig(b, x, t, steps=STEPS, alpha_star=0.9),
            lambda b, x, t: TG.lig(b, x, t, steps=STEPS, alpha_star=0.9)),
}


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


@pytest.mark.parametrize("name", sorted(METHODS))
def test_method_matches_xai_tpu(twins, name):
    jb, tb, x, target = twins
    jfn, tfn = METHODS[name]
    ref = np.asarray(jfn(jb, jnp.asarray(x), target))
    got = tfn(tb, torch.from_numpy(x), target).numpy()
    assert got.shape == ref.shape == (HW, HW, 3)
    # float32 forward+backward in two libraries (XLA CPU vs oneDNN): the
    # sums run in different orders, ~1e-6 relative per layer
    scale = np.max(np.abs(ref))
    assert np.max(np.abs(got - ref)) <= 1e-5 * scale
    sal_ref = JG.to_saliency(ref)
    sal = TG.to_saliency(torch.from_numpy(got))
    assert sal.shape == (HW, HW)
    np.testing.assert_allclose(sal, sal_ref, atol=1e-5 * scale * 3)


def test_ig_chunking_is_invisible(twins):
    """The chunk size changes only how many images share one backward."""
    _, tb, x, target = twins
    xt = torch.from_numpy(x)
    whole = TG.ig(tb, xt, target, steps=STEPS, chunk=STEPS)
    # chunk 3 does not divide 8: like xai_tpu it steps down to 2
    split = TG.ig(tb, xt, target, steps=STEPS, chunk=3)
    torch.testing.assert_close(split, whole, rtol=1e-5, atol=1e-6)


def test_ig_image_baseline_matches_xai_tpu(twins):
    """A per-pixel [H, W, C] baseline, in the public layout."""
    jb, tb, x, target = twins
    base = np.random.RandomState(8).randn(HW, HW, 3).astype(np.float32)
    ref = np.asarray(JG.ig(jb, jnp.asarray(x), target, steps=STEPS,
                           baseline=jnp.asarray(base)))
    got = TG.ig(tb, torch.from_numpy(x), target, steps=STEPS,
                baseline=torch.from_numpy(base)).numpy()
    assert np.max(np.abs(got - ref)) <= 1e-5 * np.max(np.abs(ref))


def test_lig_cutoff_matches_manual(twins):
    """LIG averages the gradients of the steps before the first logit above
    alpha* x max (saliencyMethods.py:48-67)."""
    _, tb, x, target = twins
    xt = torch.from_numpy(x)
    xc = xt.permute(2, 0, 1)
    alphas = torch.linspace(0, 1, STEPS).view(-1, 1, 1, 1)
    grads, logits = tb.score_and_grad(alphas * xc[None], target)
    above = (logits > logits.max() * 0.9).nonzero()
    cut = max(int(above[0]) if len(above) else 1, 1)
    manual = (grads[:cut].mean(0) * xc).permute(1, 2, 0)
    got = TG.lig(tb, xt, target, steps=STEPS)
    torch.testing.assert_close(got, manual, rtol=1e-5, atol=1e-6)
