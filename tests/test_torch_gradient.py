"""Gradient-path attributions of xai_tpu_torch against xai_tpu on TINY_R.

The same carried weights and the same numpy input go through
xai_tpu.methods.gradient and its port, on the CPU.  SmoothGrad gets the
same injected noise in both packages (their generators never draw alike).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xai_tpu.methods import gradient as JG
from xai_tpu.runners.common import build_bundle as jax_build_bundle
from xai_tpu.runners.common import save_params

from xai_tpu_torch.methods import gradient as TG
from xai_tpu_torch.runners.common import build_bundle

from torch_one_thread import one_torch_thread  # noqa: F401 (autouse)

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
    "idg": (lambda b, x, t: JG.idg(b, x, t, steps=STEPS),
            lambda b, x, t: TG.idg(b, x, t, steps=STEPS)),
    "idgi": (lambda b, x, t: JG.idgi(b, x, t, steps=STEPS),
             lambda b, x, t: TG.idgi(b, x, t, steps=STEPS)),
}
SG_SAMPLES = 3


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


def _noises(x, seed=4):
    rs = np.random.RandomState(seed)
    return (0.15 * (x.max() - x.min())
            * rs.randn(SG_SAMPLES, *x.shape)).astype(np.float32)


@pytest.mark.parametrize("attribution,quirk", [
    ("IG", True), ("LIG", True), ("IDG", True), ("IG", False)],
    ids=["ig", "lig", "idg", "ig_all_channels"])
def test_smooth_grad_matches_xai_tpu(twins, attribution, quirk):
    jb, tb, x, target = twins
    noises = _noises(x)
    ref = np.asarray(JG.smooth_grad(
        jb, jnp.asarray(x), target, jax.random.PRNGKey(0), attribution,
        STEPS, 0.0, reference_quirk=quirk, noises=noises))
    got = TG.smooth_grad(tb, torch.from_numpy(x), target, None, attribution,
                         STEPS, 0.0, reference_quirk=quirk,
                         noises=noises).numpy()
    assert got.shape == ref.shape == (HW, HW, 3)
    assert np.max(np.abs(got - ref)) <= 1e-5 * np.max(np.abs(ref))
    if quirk:                  # channel 0 broadcast over the channels
        assert np.array_equal(got[..., 0], got[..., 2])


def test_smooth_grad_draws_from_the_generator(twins):
    _, tb, x, target = twins
    xt = torch.from_numpy(x)

    def run(seed):
        return TG.smooth_grad(tb, xt, target,
                              torch.Generator("cpu").manual_seed(seed),
                              steps=4, samples=2)

    torch.testing.assert_close(run(3), run(3), rtol=0, atol=0)
    drawn = TG.sg_noise(xt, 2, torch.Generator("cpu").manual_seed(3))
    torch.testing.assert_close(run(3), TG.smooth_grad(
        tb, xt, target, None, steps=4, noises=drawn), rtol=0, atol=0)
    assert not torch.equal(run(3), run(4))
    with pytest.raises(ValueError, match="generator"):
        TG.smooth_grad(tb, xt, target)


@pytest.mark.parametrize("seed", range(6))
def test_alpha_parameters_match_xai_tpu(seed):
    """The redistribution of the sample budget, ties included: slopes with
    repeated values and a zero segment."""
    rs = np.random.RandomState(seed)
    steps = 8 if seed % 2 else 50
    slopes = rs.randint(-3, 6, steps).astype(np.float32) * 0.5
    slopes[0] = 0.0
    step_size = 1.0 / (steps - 1)
    ja, js = JG._alpha_parameters(jnp.asarray(slopes), steps, step_size)
    ta, ts = TG._alpha_parameters(torch.from_numpy(slopes), steps, step_size)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-6)
    # the slots fill [0, 1) in order, one window of step_size a segment
    assert np.all(np.diff(ta.numpy()) > 0) and ta[0] == 0.0


def test_bf16_sweep_runs_the_bf16_copy(twins):
    """dtype=bf16: the module sees bf16 images and the result is float32;
    the float32 module is left as it was, and the bf16 copy is made once.
    (The rank contract against float32 is in test_torch_batch.py.)"""
    _, tb, x, target = twins
    seen = []
    low = tb.cast(torch.bfloat16)
    assert low is tb.cast(torch.bfloat16) and tb.cast(None) is tb
    assert low.module is not tb.module and low.dtype == torch.bfloat16
    hook = low.module.conv1.register_forward_pre_hook(
        lambda m, a: seen.append(a[0].dtype))
    try:
        got = TG.ig(tb, torch.from_numpy(x), target, steps=STEPS,
                    dtype=torch.bfloat16)
    finally:
        hook.remove()
    assert seen and set(seen) == {torch.bfloat16}
    assert got.dtype == torch.float32 and tb.dtype == torch.float32
    assert torch.isfinite(got).all()
