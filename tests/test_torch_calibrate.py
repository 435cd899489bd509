"""MAS calibration, MAC and the recalibration samplers of xai_tpu_torch
against xai_tpu's, on the CPU.

The model is xai_tpu's 32 px test ViT carried through ``.npz``.  The
differentiable MAS tail meets kinks on ordinary inputs: a deletion pass's
penalty |resp - dens| is exactly 0 at step 0, the corrected curve sits on
the clip's bounds, and min and max can tie.  JAX and torch take
different subgradients at |0| (1 against 0) and at a clip bound (0.5
against 1); the port keeps JAX's, and ``test_differentiable_mas_grad_at_
the_kinks`` holds its gradients to ``jax.grad`` on inputs that hit every
kink (and shows that torch's own abs and clamp would not).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xai_tpu.methods import mac as JMAC
from xai_tpu.methods import mas_calibrate as JC
from xai_tpu.methods import recalibration as JR
from xai_tpu.metrics.curves import pixel_flip_steps
from xai_tpu.native import slic
from xai_tpu.ops.blur import make_blur_fn as jax_blur

from xai_tpu_torch.methods import mac as TMAC
from xai_tpu_torch.methods import mas_calibrate as TCAL
from xai_tpu_torch.methods import recalibration as TR
from xai_tpu_torch.ops.blur import make_blur_fn

from test_torch_vit import close, tiny_vit_twins
from torch_one_thread import one_torch_thread  # noqa: F401 (autouse)

H = 16


@pytest.fixture(scope="module")
def twins(tmp_path_factory):
    jb, tb = tiny_vit_twins(str(tmp_path_factory.mktemp("p") / "vit.npz"))
    rs = np.random.RandomState(2)
    x = rs.randn(32, 32, 3).astype(np.float32)
    base = np.abs(rs.randn(32, 32, 3)).astype(np.float32)
    trans = np.random.RandomState(3).rand(32, 32, 3).astype(np.float32)
    return jb, tb, x, base, trans


def _kink_inputs(mode):
    """An attribution with zero pixels (|0|), a response with ties, and a
    deletion curve that starts at its density (penalty 0 at step 0)."""
    rs = np.random.RandomState(0)
    attr = rs.rand(H, H, 3).astype(np.float32)
    attr[:4] = 0.0
    attr[4, :3] = -attr[4, :3].sum(-1, keepdims=True) / 3  # sums to ~0
    flip = pixel_flip_steps(np.abs(attr.sum(-1)), H)
    ramp = np.linspace(1, 0, H + 1) if mode == "del" else \
        np.linspace(0, 1, H + 1)
    resp = np.clip(ramp * 1.3 - 0.15, 0, 1)       # on the clip's bounds
    resp[6:9] = resp[6]                           # ties
    return attr, flip, resp


@pytest.mark.parametrize("mode", ["del", "ins"])
def test_differentiable_mas_grad_at_the_kinks(mode):
    attr, flip, resp = _kink_inputs(mode)

    def jscore(a):
        return JC.differentiable_mas(a, flip, resp, H, mode)[0]

    ref_s = float(jscore(jnp.asarray(attr)))
    ref_g = np.asarray(jax.grad(jscore)(jnp.asarray(attr)))
    a = torch.from_numpy(attr).requires_grad_(True)
    s, p = TCAL.differentiable_mas(a, flip, resp, H, mode)
    (g,) = torch.autograd.grad(s, a)
    assert abs(float(s) - ref_s) < 1e-6
    close(g, ref_g, 1e-5)
    # the kinks are hit: torch's own subgradients give another gradient
    with torch.enable_grad():
        plain_abs, plain_clip = TCAL.jax_abs, TCAL.jax_clip
        try:
            TCAL.jax_abs = torch.abs
            TCAL.jax_clip = torch.clamp
            a2 = torch.from_numpy(attr).requires_grad_(True)
            (g2,) = torch.autograd.grad(TCAL.differentiable_mas(
                a2, flip, resp, H, mode)[0], a2)
        finally:
            TCAL.jax_abs, TCAL.jax_clip = plain_abs, plain_clip
    assert float((g2 - g).abs().max()) > 1e-3 * float(np.abs(ref_g).max())


def test_kink_rules_are_jaxs():
    x = torch.tensor([0.0, -0.0, 1.0, -2.0], requires_grad=True)
    (g,) = torch.autograd.grad(TCAL.jax_abs(x).sum(), x)
    assert g.tolist() == [float(v) for v in jax.grad(
        lambda v: jnp.abs(v).sum())(jnp.array([0.0, -0.0, 1.0, -2.0]))]
    y = torch.tensor([0.0, 1.0, 0.5, -1.0, 2.0], requires_grad=True)
    (g,) = torch.autograd.grad(TCAL.jax_clip(y, 0.0, 1.0).sum(), y)
    assert g.tolist() == [float(v) for v in jax.grad(
        lambda v: jnp.clip(v, 0, 1).sum())(jnp.array(
            [0.0, 1.0, 0.5, -1.0, 2.0]))]


@pytest.mark.parametrize("mode", ["ins", "del"])
def test_mas_score_and_response_match(twins, mode):
    jb, tb, x, base, _ = twins
    ref = JC.mas_score(jb, x, base, mode)
    got = TCAL.mas_score(tb, torch.from_numpy(x), base, mode)
    np.testing.assert_allclose(got, ref, atol=1e-5)
    np.testing.assert_allclose(
        TCAL.mas_response(tb, x, base, mode, special_version=True),
        JC.mas_response(jb, x, base, mode, special_version=True), atol=1e-5)


@pytest.mark.parametrize("segmented", [False, True],
                         ids=["pixels", "segments"])
def test_refine_attribution_matches(twins, segmented):
    """3 epochs of Adam on the differentiable MAS loss: the best map (and
    its smoothed variant) within 1e-4 of xai_tpu's."""
    jb, tb, x, base, trans = twins
    seg = slic(trans, 16, 10000.0) if segmented else None
    ref = JC.refine_attribution(jb, x, base, epochs=3, segments=seg)
    got = TCAL.refine_attribution(tb, torch.from_numpy(x), base, epochs=3,
                                  segments=seg)
    if not segmented:
        ref, got = (ref,), (got,)
    for g, r in zip(got, ref):
        close(g, r, 1e-4)


def test_adam_is_optaxs():
    import optax
    rs = np.random.RandomState(5)
    p0 = rs.randn(6).astype(np.float32)
    grads = [rs.randn(6).astype(np.float32) for _ in range(4)]
    opt = optax.adam(1e-2)
    p, state = jnp.asarray(p0), opt.init(jnp.asarray(p0))
    tp = torch.from_numpy(p0)
    adam = TCAL.Adam(1e-2, tp)
    for g in grads:
        upd, state = opt.update(jnp.asarray(g), state)
        p = optax.apply_updates(p, upd)
        tp = adam.step(tp, torch.from_numpy(g))
    np.testing.assert_allclose(tp.numpy(), np.asarray(p), atol=1e-7)


@pytest.mark.parametrize("mode", ["del", "ins"])
def test_calibrate_density_and_remove_pixels_match(twins, mode):
    jb, tb, x, base, trans = twins
    close(TCAL.calibrate_density(tb, x, base, mode=mode),
          JC.calibrate_density(jb, x, base, mode=mode), 1e-4)
    close(TCAL.remove_pixels(tb, x, base, mode=mode),
          JC.remove_pixels(jb, x, base, mode=mode), 1e-6)
    seg = slic(trans, 16, 10000.0)
    close(TCAL.remove_pixels(tb, x, base, mode=mode, segments=seg),
          JC.remove_pixels(jb, x, base, mode=mode, segments=seg), 1e-6)


def test_heuristic_lr_keeps_the_quirk():
    for total in (5.0, 300.0, 700.0, 5000.0, 20000.0):
        a = np.full((1, 1, 3), total / 3, np.float32)
        assert TCAL.heuristic_lr(a) == JC.heuristic_lr(a)


@pytest.mark.parametrize("mode", ["ins", "del"])
def test_mac_matches(twins, mode):
    """retrieve_maf on SLIC segments, and clean_attribution (two rounds,
    Felzenszwalb segments) with the blur substrate."""
    jb, tb, x, base, trans = twins
    seg = slic(trans, 16, 10000.0)
    sal2d = np.abs(base.sum(-1))
    ref = JMAC.retrieve_maf(jb, x, sal2d, seg, mode, jax_blur(31, 31.0))
    got = TMAC.retrieve_maf(tb, x, sal2d, seg, mode, make_blur_fn(31, 31.0))
    close(got[0], ref[0], 1e-4)
    assert np.array_equal(got[1], ref[1])
    close(got[2], ref[2], 1e-4)
    ref = JMAC.clean_attribution(jb, trans, x, base, 2, mode,
                                 jax_blur(31, 31.0))
    got = TMAC.clean_attribution(tb, trans, x, base, 2, mode,
                                 make_blur_fn(31, 31.0))
    close(got[0], ref[0], 1e-4)
    assert got[1:] == ref[1:]


@pytest.mark.parametrize("name", ["ig_sg", "ig_uniform"])
def test_recalibration_matches_with_injected_refs(twins, name):
    """The reference bag injected into both packages (xai_tpu's own draw);
    the port's own draw from a generator is reproducible."""
    jb, tb, x, _, _ = twins
    key = jax.random.PRNGKey(7)
    xj = jnp.asarray(x)
    if name == "ig_sg":
        std = 0.15 * (xj.max() - xj.min())
        refs = xj[None] + std * jax.random.normal(key, (10,) + x.shape)
    else:
        refs = jax.random.uniform(key, (10,) + x.shape, xj.dtype, -1.0, 1.0)
    ref = getattr(JR, name)(jb, x, 5, key)
    got = getattr(TR, name)(tb, torch.from_numpy(x), 5,
                            refs=np.asarray(refs))
    close(got, ref, 1e-4)
    draws = [getattr(TR, name)(tb, torch.from_numpy(x), 5,
                               torch.Generator().manual_seed(1))
             for _ in range(2)]
    assert torch.equal(*draws) and draws[0].shape == (32, 32, 3)
