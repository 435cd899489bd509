"""The ViT explainers of xai_tpu_torch (``methods/vit_explain.py``,
``methods/vit_lrp.py``), their registry entries and their batched path
against xai_tpu's, on the CPU.

The model is xai_tpu's 32 px test ViT at its init of PRNGKey(0), carried
through ``.npz``; the images and targets are those of xai_tpu's batch
test (tests/test_batch_attr.py vit_setup).  Each map must be within 1e-4
of xai_tpu's largest value.  The port computes a batch with every
per-image reduction per image; a batch of two different images must
equal the two single runs, and xai_tpu's vmapped batch.

bi_attn's driver setting (start_layer 4) leaves a 2-block model no head
weighted block, so its maps here are zero in both packages; a case at
start_layer 1 holds the head-weighted rollout itself.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.stats import spearmanr

from xai_tpu.methods import batch as JB
from xai_tpu.methods import vit_explain as JE
from xai_tpu.methods import vit_lrp as JL
from xai_tpu.registry import get_attribution as jax_get_attribution
from xai_tpu.registry import AttrContext as JCtx
from xai_tpu.registry_vit import VIT_METHODS as JAX_VIT_METHODS

from xai_tpu_torch.methods import batch as TB
from xai_tpu_torch.methods import vit_explain as TE
from xai_tpu_torch.methods import vit_lrp as TL
from xai_tpu_torch.models import vit as tvit
from xai_tpu_torch.registry import VIT_METHODS, AttrContext, get_attribution

from test_torch_vit import CFG32, close, redraw, tiny_vit_twins
from torch_one_thread import one_torch_thread  # noqa: F401 (autouse)

VIT_NAMES = ["attn", "grad", "cam_attn", "n_rollout", "rollout", "t_attn",
             "attn_ig", "attn_attr", "bi_attn", "InFlow", "t_attr"]
TARGETS = [3, 0, 11]

# (xai_tpu function, port function, takes a target, kwargs)
EXPLAINERS = {
    "raw_attn": (JE.raw_attn, TE.raw_attn, False, {}),
    "attn_grad": (JE.attn_grad, TE.attn_grad, True, {}),
    "cam_attn": (JE.cam_attn, TE.cam_attn, True, {}),
    "naive_rollout": (JE.naive_rollout, TE.naive_rollout, False, {}),
    "rollout": (JE.rollout, TE.rollout, False, {}),
    "rollout_start1": (JE.rollout, TE.rollout, False, {"start_layer": 1}),
    "inflow_rollout": (JE.inflow_rollout, TE.inflow_rollout, False, {}),
    "transition_attention": (JE.transition_attention,
                             TE.transition_attention, True, {}),
    "attn_ig": (JE.attn_ig, TE.attn_ig, True, {}),
    "attn_attr": (JE.attn_attr, TE.attn_attr, True, {}),
    "bidirectional": (JE.bidirectional, TE.bidirectional, True, {}),
    "bidirectional_start1": (JE.bidirectional, TE.bidirectional, True,
                             {"start_layer": 1}),
    "rave": (JE.rave, TE.rave, True, {}),
    "rave_nograd_ablate1": (JE.rave, TE.rave, True,
                            {"withgrad": False, "ablate": 1}),
    "transformer_attribution": (JL.transformer_attribution,
                                TL.transformer_attribution, True, {}),
    "lrp_rollout": (JL.lrp_rollout, TL.lrp_rollout, True, {}),
    "lrp_layer": (JL.lrp_layer, TL.lrp_layer, True, {}),
    "lrp_layer_ablation": (JL.lrp_layer, TL.lrp_layer, True,
                           {"layer": 0, "is_ablation": True}),
    "lrp_full": (JL.lrp_full, TL.lrp_full, True, {}),
}


@pytest.fixture(scope="module")
def twins(tmp_path_factory):
    jb, tb = tiny_vit_twins(str(tmp_path_factory.mktemp("p") / "vit.npz"))
    xs = np.random.RandomState(2).randn(3, 32, 32, 3).astype(np.float32)
    return jb, tb, xs


@pytest.mark.parametrize("name", list(EXPLAINERS))
def test_explainer_matches_xai_tpu(twins, name):
    jb, tb, xs = twins
    jfn, tfn, targeted, kw = EXPLAINERS[name]
    for x, t in zip(xs, TARGETS):
        args = (t,) if targeted else ()
        ref = np.asarray(jfn(jb, x, *args, **kw))
        xt = torch.from_numpy(x)[None]
        got = tfn(tb, xt, *([[t]] if targeted else []), **kw)
        assert got.shape[0] == 1
        if name.startswith("bidirectional") and not kw:
            assert not ref.any() and not got.any()
            continue
        close(got[0], ref, 1e-4)


def test_attention_gradients_match(twins):
    """The probe gradients of every block, of the last block along the
    20-step path, and of each block's own probabilities."""
    jb, tb, xs = twins
    x, t = xs[:1], TARGETS[0]
    xb = torch.from_numpy(x.transpose(0, 3, 1, 2).copy())
    tg = torch.tensor([t])
    _, jg = JE.collect(jb, x, t)
    _, tgr = TE.collect(tb, torch.from_numpy(x), [t])
    close(tgr, jg, 1e-5)
    ref = JE._attn_ig_grads(jb.apply_probed, jb.extras, jb.params,
                            jnp.asarray(x), t, 20)
    close(TE._attn_ig_grads(tb, xb, tg, 20), ref, 1e-5)
    # a chunk that splits the 20 rows gives the same sums
    close(TE._attn_ig_grads(tb, xb, tg, 20, chunk=7), ref, 1e-5)
    ref = JE._bottom_up_attn_grads(jb.apply_probed, jb.extras, jb.params,
                                   jnp.asarray(x), t)
    close(TE._bottom_up_attn_grads(tb, xb, tg), ref, 1e-5)


def test_lrp_sweep_matches_on_shared_taps(tmp_path):
    """The relevance sweep's arithmetic, on weights with every bias and
    LayerNorm parameter redrawn and on xai_tpu's own taps.  End to end on
    such weights the two packages' t_attr can differ by ~1e-3: the Add
    rule's ``S = R / (x_plus + mlp_val)`` (vit_lrp.py ``_add_rp``) divides
    by block outputs whose elements cancel to ~1e-4 of their summands,
    and so scales the float32 rounding of the two forwards' taps (~1e-7)
    by ~1e4; against a float64 run each package's float32 t_attr is off by
    up to ~1e-3 on such inputs, xai_tpu's as much as the port's."""
    rs = np.random.RandomState(0)
    jb0, _ = tiny_vit_twins(str(tmp_path / "a.npz"))
    jb, tb = tiny_vit_twins(str(tmp_path / "b.npz"),
                            redraw(jb0.params, rs))
    for t in range(3):
        x = rs.randn(1, 32, 32, 3).astype(np.float32)
        ref_cams, ref_bottom, jtaps = JL._attn_cams_and_bottom(
            jb.apply_probed, jb.extras, jb.params, jnp.asarray(x), t)
        taps = {k: torch.from_numpy(np.array(v)) for k, v in jtaps.items()}
        cams, bottom = TL._attn_cams_and_bottom(tb, taps, torch.tensor([t]))
        close(cams, ref_cams, 1e-4)
        close(bottom, ref_bottom, 1e-4)


def test_registry_names_are_xai_tpus():
    assert set(VIT_METHODS) == set(JAX_VIT_METHODS)
    assert set(TB.VIT_PATCH_MAPS) == set(VIT_NAMES)
    assert set(TB.BATCH_NAMES["vit"]) == set(JB.BATCH_NAMES["vit"])


@pytest.mark.parametrize("name", VIT_NAMES)
def test_registry_entry_matches_xai_tpu(twins, name):
    """[H, W] saliency: the patch map upsampled (xai_tpu's weight
    matrices), abs."""
    jb, tb, xs = twins
    x, t = xs[1], TARGETS[1]
    ref = jax_get_attribution("vit", name, JCtx(
        bundle=jb, x=jnp.asarray(x), trans_img=x, target=t,
        key=jax.random.PRNGKey(0), img_hw=32))
    got = get_attribution("vit", name, AttrContext(
        bundle=tb, x=torch.from_numpy(x), trans_img=x, target=t, img_hw=32))
    assert got.shape == (32, 32) and got.dtype == np.float32
    if name == "bi_attn":
        assert not ref.any() and not got.any()
    else:
        close(got, ref, 1e-4)


@pytest.mark.parametrize("name", VIT_NAMES)
def test_batch_matches_single_and_xai_tpu(twins, name):
    """Two different images in one batch: each row equals its single run
    (every per-image reduction stays per image) and xai_tpu's vmapped
    batch."""
    jb, tb, xs = twins
    xs2, tg = xs[:2], np.array(TARGETS[:2])
    got = TB.batch_attribution("vit", name, tb, xs2, xs2, tg, None,
                               img_hw=32)
    assert got.shape == (2, 32, 32) and got.dtype == np.float32
    keys = np.stack([np.asarray(jax.random.PRNGKey(i)) for i in range(2)])
    ref = JB.batch_attribution("vit", name, jb, xs2, xs2, tg, keys,
                               img_hw=32)
    for i in range(2):
        single = get_attribution("vit", name, AttrContext(
            bundle=tb, x=torch.from_numpy(xs2[i]), trans_img=xs2[i],
            target=int(tg[i]), img_hw=32))
        if name == "bi_attn":
            assert not got[i].any() and not ref[i].any()
            continue
        close(got[i], single, 1e-5)
        close(got[i], ref[i], 1e-4)
    if name not in ("attn", "n_rollout", "rollout", "bi_attn"):
        # the two targets differ, and each row reads its own
        assert not np.allclose(got[0], got[1])


@pytest.mark.parametrize("name", VIT_NAMES)
def test_batch_bf16_runs_the_cast_copy(twins, name, monkeypatch):
    """dtype=bf16 runs the explainer on the bundle's bf16 copy; finite
    float32 maps of the right shape.  rollout keeps xai_tpu's rank
    contract against float32, Spearman rho > 0.95 per image
    (tests/test_batch_attr.py)."""
    jb, tb, xs = twins
    seen = []
    forward = tvit.VisionTransformer.forward

    def spy(self, x, *args, **kwargs):
        seen.append((x.dtype, self.head.weight.dtype))
        return forward(self, x, *args, **kwargs)

    monkeypatch.setattr(tvit.VisionTransformer, "forward", spy)
    xs2, tg = xs[:2], np.array(TARGETS[:2])
    b16 = TB.batch_attribution("vit", name, tb, xs2, xs2, tg, None,
                               img_hw=32, dtype=torch.bfloat16)
    monkeypatch.undo()
    assert seen and set(seen) == {(torch.bfloat16, torch.bfloat16)}
    assert b16.shape == (2, 32, 32) and b16.dtype == np.float32
    assert np.isfinite(b16).all()
    if name == "rollout":
        f32 = TB.batch_attribution("vit", name, tb, xs2, xs2, tg, None,
                                   img_hw=32)
        for a, b in zip(f32, b16):
            assert spearmanr(a.ravel(), b.ravel()).statistic > 0.95


# TIS's 1024 masks need 1024 activation rows (depth x width; the test
# ViT has 64): its case runs the test ViT's patches at 4 blocks of 256,
# where every row is its own centroid whatever k-means draws
CFG_TIS = dict(CFG32, embed_dim=256, depth=4)


def _vit_cx_noise(monkeypatch):
    """ViT-CX's noise injected into both packages' entries: the k-th call
    draws numpy's RandomState(k) at its image's cluster count."""
    from xai_tpu.methods import vit_cx as JX
    from xai_tpu_torch.methods import vit_cx as TX

    def noise(k, count):
        count.append(None)
        return (np.random.RandomState(len(count)).randn(k, 32, 32, 3)
                * 0.1).astype(np.float32)

    def jax_vit_cx(bundle, x, target=None, key=None, dtype=None, count=[],
                   real=JX.vit_cx):
        _, tri, _ = JX._masks_and_sim_jit(bundle.apply_taps, bundle.params,
                                          jnp.asarray(x)[None], 32)
        k = int(JX._cluster_host(np.asarray(tri), 32, 0.1).max()) + 1
        return real(bundle, x, target, noise=noise(k, count), dtype=dtype)

    def torch_vit_cx(bundle, x, target=None, generator=None, dtype=None,
                     count=[], real=TX.vit_cx):
        sim = TX._masks_and_sim(bundle, x.permute(2, 0, 1)[None])[1]
        k = int(TX.cluster_host(sim[0].numpy(), 0.1).max()) + 1
        return real(bundle, x, target, noise=noise(k, count), dtype=dtype)

    monkeypatch.setattr(JX, "vit_cx", jax_vit_cx)
    monkeypatch.setattr(TX, "vit_cx", torch_vit_cx)


@pytest.mark.parametrize("name", ["TIS", "VIT_CX", "MDA", "MDA_dense"])
def test_slice2_names_raise(twins, tmp_path, monkeypatch, name):
    """The four names that raised naming A10 slice 2 now run: the
    registry entry matches xai_tpu's within 1e-4 (ViT-CX with injected
    noise), and the batched entry is VIT_CX's batch (each row its single
    run) or, for the names xai_tpu runs image by image, None."""
    jb, tb, xs = twins
    if name == "TIS":
        jb, tb = tiny_vit_twins(str(tmp_path / "tis.npz"), cfg=CFG_TIS)
    _vit_cx_noise(monkeypatch)
    trans = np.random.RandomState(3).rand(32, 32, 3).astype(np.float32)
    x, t = xs[0], TARGETS[0]
    ref = jax_get_attribution("vit", name, JCtx(
        bundle=jb, x=jnp.asarray(x), trans_img=trans, target=t,
        key=jax.random.PRNGKey(0), img_hw=32))
    got = get_attribution("vit", name, AttrContext(
        bundle=tb, x=torch.from_numpy(x), trans_img=trans, target=t,
        img_hw=32))
    assert got.shape == (32, 32) and np.isfinite(got).all()
    close(got, ref, 1e-4)
    monkeypatch.undo()
    batched = TB.batch_attribution("vit", name, tb, xs[:2], xs[:2], [1, 2],
                                   [torch.Generator().manual_seed(i)
                                    for i in range(2)], img_hw=32)
    if name != "VIT_CX":
        # xai_tpu runs them image by image: the caller loops the registry
        assert batched is None
        return
    for i in range(2):
        single = get_attribution("vit", name, AttrContext(
            bundle=tb, x=torch.from_numpy(xs[i]), trans_img=xs[i],
            target=i + 1, img_hw=32,
            generator=torch.Generator().manual_seed(i)))
        close(batched[i], single, 1e-5)
