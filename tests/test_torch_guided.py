"""Guided backprop, Grad-CAM and the resize ops of xai_tpu_torch against
xai_tpu, on the CPU.

TINY_R twins from one ``.npz``; the same numpy input goes through
``xai_tpu/methods/guided.py`` and its port.  Tolerances are relative to
the reference's largest |value|.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xai_tpu.methods import guided as JGD
from xai_tpu.ops import resize as JR
from xai_tpu.runners.common import build_bundle as jax_build_bundle
from xai_tpu.runners.common import save_params

from xai_tpu_torch.methods import guided as GD
from xai_tpu_torch.models import resnet
from xai_tpu_torch.ops import resize as TR
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


def test_guided_relu_rule_is_exact():
    """Forward relu; backward g * (g > 0) * (x > 0), xai_tpu's rule."""
    rs = np.random.RandomState(0)
    x = torch.from_numpy(rs.randn(4, 50).astype(np.float32))
    x[0, :5] = 0.0
    g = torch.from_numpy(rs.randn(4, 50).astype(np.float32))
    xr = x.clone().requires_grad_(True)
    y = GD.guided_relu(xr)
    (got,) = torch.autograd.grad(y, xr, g)
    assert torch.equal(y, torch.relu(x))
    want = g * (g > 0) * (x > 0)
    assert torch.equal(got, want)
    ref = JGD._guided_bwd(jnp.asarray(x.numpy()), jnp.asarray(g.numpy()))[0]
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("name", ["gbp", "gc", "ggc"])
def test_guided_methods_match_xai_tpu(twins, name):
    jb, tb, x, target = twins
    xt = torch.from_numpy(x)
    if name == "gbp":
        ref = JGD.guided_backprop(jb, x, target)
        got = GD.guided_backprop(tb, xt, target)
    elif name == "gc":
        ref = JGD.grad_cam(jb, x, target, img_hw=HW)
        got = GD.grad_cam(tb, xt, target, img_hw=HW)
    else:
        ref = JGD.guided_grad_cam(jb, x, target, img_hw=HW)
        got = GD.guided_grad_cam(tb, xt, target, img_hw=HW)
    assert got.shape == np.shape(ref) == (HW, HW, 3)
    assert _rel(got, ref) <= 1e-5


def test_layer_gradcam_matches_xai_tpu(twins):
    """The CAM before its upsample, and without the final relu."""
    jb, tb, x, target = twins
    xb = torch.from_numpy(x).permute(2, 0, 1)[None]
    for relu in (True, False):
        ref = JGD._layer_gradcam(jb.apply_probed, jb.params, jnp.asarray(x),
                                 target, "layer4", relu)
        got = GD.layer_gradcam(tb, xb, target, "layer4", relu)[0]
        assert got.shape == ref.shape == (2, 2)
        assert _rel(got, ref) <= 1e-5


def test_apply_probed_gradient_matches_xai_tpu(twins):
    """The gradient with respect to a zero layer3 probe, against xai_tpu's
    apply_probed; the probe leaves the logits as they are."""
    import jax

    jb, tb, x, target = twins
    xj = jnp.asarray(x)[None]
    _, taps = jb.apply_probed(jb.params, xj, None)

    def score(p):
        return jb.apply_probed(jb.params, xj, {"layer3": p})[0][0, target]

    ref = np.asarray(jax.grad(score)(jnp.zeros_like(taps["layer3"])))
    xt = torch.from_numpy(x).permute(2, 0, 1)[None]
    probe = torch.zeros(ref.shape[0], ref.shape[3], *ref.shape[1:3],
                        requires_grad=True)
    logits, ttaps = tb.apply_probed(xt, {"layer3": probe})
    (got,) = torch.autograd.grad(logits[0, target], probe)
    assert torch.equal(logits, tb.apply(xt))
    assert _rel(got.permute(0, 2, 3, 1).numpy(), ref) <= 1e-5
    assert ttaps["layer3"].shape == probe.shape


def test_guided_copy_is_made_once(twins):
    """ModelBundle.guided() swaps every ReLU of a copy and keeps it; the
    bundle's own module keeps torch's relu."""
    _, tb, _, _ = twins
    g = tb.guided()
    assert g is tb.guided() and g.module is not tb.module
    relus = {m.relu for m in g.module.modules()
             if isinstance(m, (resnet.ResNet, resnet.Bottleneck))}
    assert relus == {GD.guided_relu}
    assert all(m.relu is torch.nn.functional.relu for m in tb.module.modules()
               if isinstance(m, (resnet.ResNet, resnet.Bottleneck)))
    low = tb.cast(torch.bfloat16)
    assert low.guided().dtype == torch.bfloat16


@pytest.mark.parametrize("shape,hw", [((7, 7), (64, 64)),
                                      ((3, 14, 14), (224, 224)),
                                      ((2, 3, 8, 8), (252, 252)),
                                      ((3, 224, 224), (14, 14)),
                                      ((64, 64), (7, 7))])
def test_resize_bilinear_matches_xai_tpu(shape, hw):
    """F.interpolate bilinear, antialiased when it shrinks, against
    jax.image.resize(method="linear", antialias=True)."""
    x = np.random.RandomState(4).rand(*shape).astype(np.float32)
    if len(shape) == 4:                  # xai_tpu's 4-d layout is NHWC
        ref = np.asarray(JR.resize_bilinear(jnp.asarray(
            x.transpose(0, 2, 3, 1)), hw)).transpose(0, 3, 1, 2)
    else:
        ref = np.asarray(JR.resize_bilinear(jnp.asarray(x), hw))
    got = TR.resize_bilinear(torch.from_numpy(x), hw).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)


@pytest.mark.parametrize("shape,hw", [((3, 64, 64), (14, 14)),
                                      ((3, 224, 224), (14, 14)),
                                      ((2, 2), (64, 64)),
                                      ((5, 7), (13, 9))])
def test_resize_nearest_exact_is_bit_exact(shape, hw):
    x = np.random.RandomState(5).rand(*shape).astype(np.float32)
    ref = np.asarray(JR.resize_nearest_exact(jnp.asarray(x), hw))
    got = TR.resize_nearest_exact(torch.from_numpy(x), hw).numpy()
    np.testing.assert_array_equal(got, ref)
