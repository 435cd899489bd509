"""The batched production path of xai_tpu_torch against xai_tpu, on the CPU.

``batch_attribution`` and the batched IG-family sweeps of
``xai_tpu_torch/methods/batch.py`` against ``xai_tpu/methods/batch.py`` on
TINY_R at 64 px with carried weights; SmoothGrad gets the noise that
xai_tpu's ``_sg_batch_jit`` draws from its keys, injected.  The port's
batched path must also equal its own per-image path on the same
generators.  The bf16 rank contracts are xai_tpu's
(``tests/test_batch_attr.py``), on a twin of its tiny CNN.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn as nn
import torch.nn.functional as F
from scipy.stats import spearmanr

from xai_tpu.methods import batch as JB
from xai_tpu.runners.common import build_bundle as jax_build_bundle
from xai_tpu.runners.common import save_params

from xai_tpu_torch.methods import ablation as AB
from xai_tpu_torch.methods import batch as TB
from xai_tpu_torch.methods import gradient as TG
from xai_tpu_torch.methods import lime as TL
from xai_tpu_torch.models.common import ModelBundle, ModelMeta
from xai_tpu_torch.registry import AttrContext, get_attribution
from xai_tpu_torch.runners.common import build_bundle

from tiny_models import tiny_bundle
from torch_one_thread import one_torch_thread  # noqa: F401 (autouse)

HW = 64
B = 3
STEPS = 8
SAMPLES = 3


@pytest.fixture(scope="module")
def twins(tmp_path_factory):
    jb = jax_build_bundle("TINY_R", seed=6)
    path = str(tmp_path_factory.mktemp("params") / "tiny_r.npz")
    save_params(jb.params, path)
    tb = build_bundle("TINY_R", path, device="cpu")
    rs = np.random.RandomState(0)
    xs = rs.randn(B, HW, HW, 3).astype(np.float32)
    keys = np.stack([np.asarray(jax.random.fold_in(jax.random.PRNGKey(0), i))
                     for i in range(B)])
    # each image's own top class, and one forced class: the batched sweeps
    # must read every row at its own target
    targets = np.array(jnp.argmax(jb.apply(jb.params, jnp.asarray(xs)),
                                  axis=-1))
    targets[1] = (targets[1] + 3) % 1000
    return jb, tb, xs, targets, keys


def _generators(n=B, seed=0):
    return [torch.Generator("cpu").manual_seed(seed + i) for i in range(n)]


@pytest.mark.parametrize("name", ["ig", "lig", "idg", "idgi", "grad",
                                  "inp_x_grad"])
def test_batch_attribution_matches_xai_tpu(twins, name):
    jb, tb, xs, targets, keys = twins
    ref = JB.batch_attribution("cnn", name, jb, xs, xs, targets, keys,
                               img_hw=HW, steps=STEPS)
    got = TB.batch_attribution("cnn", name, tb, xs, xs, targets,
                               _generators(), img_hw=HW, steps=STEPS)
    assert got.dtype == np.float32 and got.shape == ref.shape == (B, HW, HW)
    # the tolerance of tests/test_batch_attr.py
    np.testing.assert_allclose(got, ref, atol=2e-4, rtol=2e-3, err_msg=name)


def _jax_sg_noise(xs, keys, samples):
    """The noise xai_tpu's _sg_batch_jit draws: per image,
    0.15 * (max - min) * normal(key, (samples, H, W, C))."""
    return np.stack([np.asarray(0.15 * (x.max() - x.min())
                                * jax.random.normal(jnp.asarray(k),
                                                    (samples,) + x.shape,
                                                    jnp.float32))
                     for x, k in zip(xs, keys)])


@pytest.mark.parametrize("alpha_star", [1.0, 0.9], ids=["ig", "lig"])
def test_sg_batch_matches_xai_tpu(twins, alpha_star):
    jb, tb, xs, targets, keys = twins
    ref = np.asarray(JB.sg_batch(jb, xs, targets, keys, steps=STEPS,
                                 samples=SAMPLES, alpha_star=alpha_star))
    got = TB.sg_batch(tb, torch.from_numpy(xs), torch.from_numpy(targets),
                      steps=STEPS, alpha_star=alpha_star,
                      noises=_jax_sg_noise(xs, keys, SAMPLES)).numpy()
    assert got.shape == (B, HW, HW)
    np.testing.assert_allclose(got, ref, atol=2e-4, rtol=2e-3)


@pytest.mark.parametrize("name", ["ig", "lig", "idg", "idgi", "sg", "grad",
                                  "inp_x_grad", "lime", "gbp", "gc", "ggc",
                                  "gs", "fa", "occ", "gig"])
def test_batched_equals_per_image(twins, name):
    """The driver's two paths: batch_attribution against the registry's
    per-image entry, on generators seeded alike.  (agi's batch against
    its per-image path is held at 32 px in test_torch_rise_agi.py: at 64
    px a discrete choice of the attack, a gradient's sign or a step's
    argmax, falls the other way between the batch of three and the batch
    of one.)"""
    _, tb, xs, targets, _ = twins
    trans = np.random.RandomState(3).rand(B, HW, HW, 3).astype(np.float32)
    got = TB.batch_attribution("cnn", name, tb, xs, trans, targets,
                               _generators(), img_hw=HW, steps=STEPS)
    for i, g in enumerate(_generators()):
        want = get_attribution("cnn", name, AttrContext(
            bundle=tb, x=torch.from_numpy(xs[i]), trans_img=trans[i],
            target=int(targets[i]), img_hw=HW, steps=STEPS, generator=g))
        if name == "lime":
            # lime_batch's chunk of 64 against lime's 100: the same rows
            # and the same masks
            np.testing.assert_array_equal(got[i], want)
        else:
            np.testing.assert_allclose(got[i], want, atol=2e-4, rtol=2e-3,
                                       err_msg=name)


# batch_attribution's production constants cut to 32 px, as
# tests/test_batch_attr.py cuts them
SMALL_OPTS = {"num_patches": 4, "occ_window": 8, "occ_stride": 4,
              "shap_samples": 5}


@pytest.fixture(scope="module")
def twins32(twins):
    """The twins at 32 px, where float32 forwards in XLA and oneDNN keep
    gig's quantile and agi's signs and argmaxes on the same side (at 64 px
    TINY_R's zero-bias random weights put ReLU inputs within rounding of
    zero); trans: [0, 1] images for agi."""
    jb, tb, _, _, keys = twins
    rs = np.random.RandomState(1)
    xs = rs.randn(B, 32, 32, 3).astype(np.float32)
    trans = rs.rand(B, 32, 32, 3).astype(np.float32)
    targets = np.array(jnp.argmax(jb.apply(jb.params, jnp.asarray(xs)),
                                  axis=-1))
    targets[1] = (targets[1] + 3) % 1000
    return jb, tb, xs, trans, targets, keys


@pytest.mark.parametrize("name", ["gbp", "gc", "ggc", "fa", "occ", "gig",
                                  "agi"])
def test_a8_batch_attribution_matches_xai_tpu(twins32, name):
    """The rest of the CNN family's batched path against xai_tpu's generic
    adapters (gs and shap draw from the keys: they are held against the
    port's per-image path below, and against xai_tpu in
    test_torch_ablation.py with injected draws)."""
    jb, tb, xs, trans, targets, keys = twins32
    ref = JB.batch_attribution("cnn", name, jb, xs, trans, targets, keys,
                               img_hw=32, steps=STEPS, opts=SMALL_OPTS)
    got = TB.batch_attribution("cnn", name, tb, xs, trans, targets,
                               _generators(), img_hw=32, steps=STEPS,
                               opts=SMALL_OPTS)
    assert got.dtype == np.float32 and got.shape == ref.shape == (B, 32, 32)
    np.testing.assert_allclose(got, ref, atol=2e-4, rtol=2e-3, err_msg=name)


def test_shap_batch_equals_per_image(twins32):
    """Batched Shapley sampling draws each image's permutations from its
    generator as the per-image function does."""
    _, tb, xs, _, targets, _ = twins32
    got = TB.batch_attribution("cnn", "shap", tb, xs, xs, targets,
                               _generators(), img_hw=32, opts=SMALL_OPTS)
    for i, g in enumerate(_generators()):
        want = AB.shapley_sampling(tb, torch.from_numpy(xs[i]),
                                   int(targets[i]), g, num_patches=4,
                                   n_samples=5)
        np.testing.assert_allclose(got[i], TG.to_saliency(want), atol=2e-4,
                                   rtol=2e-3)


@pytest.mark.parametrize("name", ["gbp", "gc", "ggc", "gs", "fa", "occ",
                                  "gig", "agi"])
def test_a8_bf16_batch_runs_the_bf16_copy(twins32, name):
    """dtype=bf16 runs the method's forwards on the bundle's bf16 copy and
    returns finite float32 maps (xai_tpu records no bf16 contract for
    these names)."""
    _, tb, xs, trans, targets, _ = twins32
    seen = []
    low = tb.cast(torch.bfloat16)
    hooks = [m.module.conv1.register_forward_pre_hook(
        lambda mod, a: seen.append(a[0].dtype)) for m in (low, low.guided())]
    try:
        got = TB.batch_attribution("cnn", name, tb, xs, trans, targets,
                                   _generators(), img_hw=32, steps=4,
                                   dtype=torch.bfloat16, opts=SMALL_OPTS)
    finally:
        for h in hooks:
            h.remove()
    assert seen and set(seen) == {torch.bfloat16}
    assert got.dtype == np.float32 and got.shape == (B, 32, 32)
    assert np.isfinite(got).all()


@pytest.mark.parametrize("name", ["gig", "agi"])
def test_a8_float64_copy_keeps_float64_scores(twins32, name, monkeypatch):
    """On the bundle's float64 copy, gig's and agi's softmax runs in
    float64 (the card-vs-CPU check of chip_smoke.py rests on it), and
    the maps agree with float32 at 32 px."""
    _, tb, xs, trans, targets, _ = twins32
    seen = []
    softmax = torch.softmax

    def recorded(x, *args, **kwargs):
        seen.append(x.dtype)
        return softmax(x, *args, **kwargs)

    monkeypatch.setattr(torch, "softmax", recorded)
    f64 = TB.batch_attribution("cnn", name, tb, xs, trans, targets, None,
                               img_hw=32, steps=STEPS, dtype=torch.float64,
                               opts=SMALL_OPTS)
    assert seen and set(seen) == {torch.float64} and f64.dtype == np.float32
    monkeypatch.undo()
    f32 = TB.batch_attribution("cnn", name, tb, xs, trans, targets, None,
                               img_hw=32, steps=STEPS, opts=SMALL_OPTS)
    assert np.max(np.abs(f64 - f32)) <= 1e-4 * np.max(np.abs(f32))


@pytest.mark.parametrize("family,name,item", [
    ("vit", "VIT_CX", None), ("clip", "eclip", "A11")])
def test_unported_batch_names_raise(twins, tmp_path, family, name, item):
    """No batched name raises any more.  eclip, which raised naming A11,
    now runs batched: on xai_tpu's tiny test CLIP its batch equals its
    per-image registry entries (the full CLIP cases:
    tests/test_torch_clip_methods.py).  VIT_CX, which raised naming A10
    slice 2, runs batched: on xai_tpu's 32 px test ViT its batch with
    injected noise matches xai_tpu's vit_cx image by image (3|map|, as
    the entries give it).  ``item``: the ROADMAP.md item that ported the
    name."""
    assert TB.has_batch_impl(family, name)
    if family == "clip":
        from test_torch_clip import clip_twins
        from xai_tpu_torch.models.clip import batch_extras

        _, cb = clip_twins(str(tmp_path / "clip.npz"))
        imgs = np.random.RandomState(2).randn(2, 32, 32, 3).astype(
            np.float32)
        got = TB.batch_attribution(family, name, cb, imgs, imgs, [3, 0],
                                   None, img_hw=32,
                                   extras=batch_extras(cb, [3, 0]))
        assert got.shape == (2, 32, 32) and np.isfinite(got).all()
        for i, t in enumerate([3, 0]):
            want = get_attribution(family, name, AttrContext(
                bundle=cb, x=torch.from_numpy(imgs[i]), trans_img=imgs[i],
                target=t, img_hw=32, extras={
                    k: v[i:i + 1]
                    for k, v in batch_extras(cb, [3, 0]).items()}))
            assert np.abs(got[i] - want).max() <= 1e-6 * np.abs(want).max()
        return
    import jax.numpy as jnp
    from xai_tpu.methods import vit_cx as JX
    from xai_tpu_torch.methods import vit_cx as TX
    from test_torch_vit import tiny_vit_twins

    jb, vb = tiny_vit_twins(str(tmp_path / "vit.npz"))
    imgs = np.random.RandomState(2).randn(2, 32, 32, 3).astype(np.float32)
    noise = []
    for i, x in enumerate(imgs):
        _, tri, _ = JX._masks_and_sim_jit(jb.apply_taps, jb.params,
                                          jnp.asarray(x)[None], 32)
        k = int(JX._cluster_host(np.asarray(tri), 32, 0.1).max()) + 1
        noise.append((np.random.RandomState(i).randn(k, 32, 32, 3) * 0.1)
                     .astype(np.float32))
    got = 3.0 * np.abs(TX.vit_cx_batch(vb, imgs, [3, 0], noise=noise))
    assert TB.batch_attribution("vit", name, vb, imgs, imgs, [3, 0], [
        torch.Generator().manual_seed(i) for i in range(2)],
        img_hw=32).shape == (2, 32, 32)
    for i in range(2):
        ref = 3.0 * np.abs(JX.vit_cx(jb, imgs[i], [3, 0][i],
                                     noise=noise[i]))
        assert np.abs(got[i] - ref).max() <= 1e-4 * np.abs(ref).max()


def test_unbatched_names_return_none(twins):
    """Where xai_tpu has no batched implementation either, the caller loops
    the per-image path."""
    _, tb, xs, targets, _ = twins
    for name in ("xrai", "rise"):
        assert not TB.has_batch_impl("cnn", name)
        assert TB.batch_attribution("cnn", name, tb, xs, xs, targets,
                                    _generators(), img_hw=HW) is None


# --- the bf16 contracts, on a twin of xai_tpu's tiny CNN ---

class _TinyCNN(nn.Module):
    """tests/tiny_models.py TinyCNN: two 3x3 stride-2 'SAME' convs (flax
    pads (0, 1) at 16 px), ReLU, global mean, dense."""

    def __init__(self, params):
        super().__init__()

        def conv(p):
            c = nn.Conv2d(p["kernel"].shape[2], p["kernel"].shape[3], 3, 2)
            c.weight.data = torch.from_numpy(
                np.asarray(p["kernel"]).transpose(3, 2, 0, 1).copy())
            c.bias.data = torch.from_numpy(np.asarray(p["bias"]).copy())
            return c

        self.c1, self.c2 = conv(params["c1"]), conv(params["c2"])
        self.fc = nn.Linear(*params["fc"]["kernel"].shape)
        self.fc.weight.data = torch.from_numpy(
            np.asarray(params["fc"]["kernel"]).T.copy())
        self.fc.bias.data = torch.from_numpy(
            np.asarray(params["fc"]["bias"]).copy())

    def forward(self, x):
        x = F.relu(self.c1(F.pad(x, (0, 1, 0, 1))))
        x = F.relu(self.c2(F.pad(x, (0, 1, 0, 1))))
        return self.fc(x.mean(dim=(2, 3)))


@pytest.fixture(scope="module")
def tiny_twins():
    jb = tiny_bundle(hw=16)
    tb = ModelBundle(ModelMeta(name="tiny", family="cnn", img_hw=16,
                               num_classes=10, batch_size=10),
                     _TinyCNN(jb.params))
    return jb, tb


def test_tiny_twin_is_xai_tpus_model(tiny_twins):
    jb, tb = tiny_twins
    x = np.random.RandomState(1).randn(2, 16, 16, 3).astype(np.float32)
    ref = np.asarray(jb.apply(jb.params, jnp.asarray(x)))
    got = tb.apply(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()))
    np.testing.assert_allclose(got.detach().numpy(), ref, rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("name", ["ig", "lig", "sg"])
def test_bf16_batch_rank_stable(tiny_twins, name):
    """xai_tpu's test_bf16_tolerances_recorded: the bf16 sweep keeps the
    saliency ordering (Spearman rho > 0.98 against float32)."""
    _, tb = tiny_twins
    rs = np.random.RandomState(9)
    xs = rs.randn(2, 16, 16, 3).astype(np.float32)
    targets = np.array([2, 5])
    f32, b16 = (TB.batch_attribution("cnn", name, tb, xs, xs, targets,
                                     _generators(2, 7), img_hw=16,
                                     steps=STEPS, dtype=dtype)
                for dtype in (None, torch.bfloat16))
    assert b16.dtype == np.float32
    for i in range(2):
        rho = spearmanr(f32[i].ravel(), b16[i].ravel()).statistic
        assert rho > 0.98, (name, i, rho)


def test_lime_bf16_masks_agree(tiny_twins):
    """xai_tpu's LIME bf16 contract: the masks agree on > 80 % of pixels
    (probability noise can flip marginal segments)."""
    _, tb = tiny_twins
    img = np.random.RandomState(9).rand(16, 16, 3).astype(np.float32)
    m32, m16 = (TL.lime(tb, img, torch.Generator("cpu").manual_seed(1),
                        num_samples=200, dtype=dtype, device="cpu")
                for dtype in (None, torch.bfloat16))
    assert set(np.unique(m16)) <= {0.0, 1.0}
    assert (m32 == m16).mean() > 0.8
