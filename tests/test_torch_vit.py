"""The ViT port and its weight carry against xai_tpu on the CPU.

The model is the 32 px ViT of xai_tpu's own tests (patch 8, 32 wide, 2
blocks, 4 heads, 16 classes; tests/test_batch_attr.py).  Its params, with
every bias, LayerNorm scale, ``cls_token`` and ``pos_embed`` redrawn so
that the carry of each array matters, are written with xai_tpu's
save_params and read by the port's ``load_params``; logits, every tap,
the probe gradients and the per-block probabilities must match xai_tpu's
within 1e-5 of each reference's magnitude (XLA and oneDNN sum in other
orders, ~1e-7 a layer).  The helpers here build the twins of the other
ViT test modules.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xai_tpu.methods import vit_explain as JE
from xai_tpu.models import vit as jvit
from xai_tpu.models.common import ModelMeta as JMeta
from xai_tpu.models.common import jit_bundle
from xai_tpu.ops.preprocess import VIT_MEAN, VIT_STD
from xai_tpu.runners import common as JC
from xai_tpu.runners import evaluate_sanity as JS
from xai_tpu.runners.common import save_params

from xai_tpu_torch.convert.from_jax import load_params
from xai_tpu_torch.methods import vit_explain as TE
from xai_tpu_torch.models import vit as tvit
from xai_tpu_torch.models.common import ModelBundle, ModelMeta
from xai_tpu_torch.runners import common as TC
from xai_tpu_torch.runners import evaluate_sanity as TS

from torch_one_thread import one_torch_thread  # noqa: F401 (autouse)

# xai_tpu's test ViT (tests/test_batch_attr.py vit_setup)
CFG32 = dict(patch=8, embed_dim=32, depth=2, num_heads=4, mlp_ratio=2.0,
             num_classes=16, img_hw=32)
TAPS = ["attn", "attn_logits", "v", "attn_out", "block_in", "norm1_out",
        "input_plus_attn", "mlp_val", "block_out", "patch_embedding"]


def close(got, ref, rel):
    """Max |delta| within ``rel`` of the reference's magnitude."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    scale = float(np.max(np.abs(ref)))
    assert scale > 0
    err = float(np.max(np.abs(got - ref)))
    assert err <= rel * scale, (err, scale)


def redraw(params, rs, scale=0.05):
    """Every leaf plus ``scale`` standard normal draws."""
    return jax.tree.map(
        lambda a: jnp.asarray(a + scale * rs.randn(*a.shape)
                              .astype(np.float32)), params)


def tiny_vit_twins(path, params=None, cfg=CFG32):
    """(xai_tpu bundle, port bundle) of the 32 px ViT (or ``cfg``):
    xai_tpu's init at PRNGKey(0) (or ``params``), carried through
    ``.npz`` at ``path``."""
    cfg_dict = cfg
    cfg = jvit.ViTConfig(**cfg_dict)
    model = jvit.VisionTransformer(cfg)
    if params is None:
        params = model.init(jax.random.PRNGKey(0),
                            jnp.zeros((1, 32, 32, 3)))["params"]
    jb = jit_bundle(
        meta=JMeta(name="tinyvit", family="vit", img_hw=32, num_classes=16,
                   num_patches=4, batch_size=8, mean=VIT_MEAN, std=VIT_STD),
        params=params,
        apply=lambda p, x: model.apply({"params": p}, x),
        apply_taps=lambda p, x: model.apply({"params": p}, x, taps=True),
        apply_probed=lambda p, x, pr: model.apply({"params": p}, x,
                                                  probes=pr, taps=True),
        apply_tokens=lambda p, x, ti: model.apply({"params": p}, x,
                                                  token_indices=ti),
        extras=cfg)
    save_params(params, path)
    module = tvit.VisionTransformer(tvit.ViTConfig(**cfg_dict))
    module.load_state_dict(load_params(path))
    tb = ModelBundle(ModelMeta(name="tinyvit", family="vit", img_hw=32,
                               num_classes=16, num_patches=4, batch_size=8,
                               mean=VIT_MEAN, std=VIT_STD), module)
    return jb, tb


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


@pytest.fixture(scope="module")
def twins(tmp_path_factory):
    model = jvit.VisionTransformer(jvit.ViTConfig(**CFG32))
    params = redraw(model.init(jax.random.PRNGKey(0),
                               jnp.zeros((1, 32, 32, 3)))["params"],
                    np.random.RandomState(0))
    jb, tb = tiny_vit_twins(
        str(tmp_path_factory.mktemp("params") / "vit.npz"), params)
    x = np.random.RandomState(1).randn(2, 32, 32, 3).astype(np.float32)
    return jb, tb, x


def test_logits_match(twins):
    jb, tb, x = twins
    close(tb.apply(nchw(x)).detach(), jb.apply(jb.params, jnp.asarray(x)),
          1e-5)


@pytest.mark.parametrize("tap", TAPS)
def test_taps_match(twins, tap):
    jb, tb, x = twins
    _, jt = jb.apply_taps(jb.params, jnp.asarray(x))
    with torch.no_grad():
        _, tt = tb.apply_taps(nchw(x))
    close(tt[tap], jt[tap], 1e-5)


def test_probe_gradients_match(twins):
    """d logit[target] / d attention of every block, from the additive
    zero probes of both packages."""
    jb, tb, x = twins
    for i, target in enumerate((3, 12)):
        _, jg = JE.collect(jb, x[i], target)
        _, tg = TE.collect(tb, torch.from_numpy(x[i:i + 1]), [target])
        close(tg, jg, 1e-5)


def test_embed_probe_is_the_embedding_gradient(twins):
    """A zero probe on the patch embedding changes nothing, and its
    gradient is xai_tpu's."""
    jb, tb, x = twins
    probes = jvit.zero_probes(jb.extras, 1)

    def score(pr):
        return jb.apply_probed(jb.params, jnp.asarray(x[:1]), pr)[0][0, 5]

    ref = jax.grad(score)(probes)["embed"]
    embed = torch.zeros((1, 17, 32), requires_grad=True)
    logits, _ = tb.apply_probed(nchw(x[:1]), {"embed": embed})
    (got,) = torch.autograd.grad(logits[0, 5], embed)
    close(got, ref, 1e-5)
    close(logits.detach(), jb.apply(jb.params, jnp.asarray(x[:1])), 1e-5)


@pytest.mark.parametrize("softmax", [True, False])
def test_block_probs_match(twins, softmax):
    jb, tb, x = twins
    _, jt = jb.apply_taps(jb.params, jnp.asarray(x))
    with torch.no_grad():
        _, tt = tb.apply_taps(nchw(x))
        got = tvit.block_probs(tb.module, tt["block_out"], softmax)
    close(got, jvit.block_probs(jb.params, jt["block_out"], softmax), 1e-5)


def test_token_indices_keep_cls_and_the_chosen_tokens(twins):
    jb, tb, x = twins
    keep = np.array([0, 5, 6, 15])
    ref = jvit.VisionTransformer(jb.extras).apply(
        {"params": jb.params}, jnp.asarray(x), token_indices=keep)
    with torch.no_grad():
        got = tb.module(nchw(x), token_indices=torch.from_numpy(keep))
    close(got, ref, 1e-5)


def test_weight_carry_layouts(twins):
    """The ViT keys: the patch conv HWIO -> OIHW, dense [in, out] -> [out,
    in], LayerNorm scale / bias and cls_token / pos_embed as they are."""
    jb, tb, _ = twins
    state = tb.module.state_dict()
    flat = {"/".join(str(getattr(k, "key", k)) for k in kp): np.asarray(v)
            for kp, v in jax.tree_util.tree_flatten_with_path(jb.params)[0]}
    assert len(flat) == len(state) == 32
    for key, ref in flat.items():
        *path, leaf = key.split("/")
        name = ".".join(path + ["weight" if leaf == "kernel" else leaf])
        got = state[name].numpy()
        if leaf == "kernel" and ref.ndim == 4:
            ref = ref.transpose(3, 2, 0, 1)
        elif leaf == "kernel":
            ref = ref.T
        assert np.array_equal(got, ref), key


def test_tiny_vit_carries_through_build_bundle(tmp_path, monkeypatch):
    """--model TINY_VIT --params_path: one xai_tpu .npz serves both
    packages' build_bundle (the 32 px config in both constructors)."""
    for configs in (jvit.CONFIGS, tvit.CONFIGS):
        monkeypatch.setitem(configs, "vit_tiny_patch16_224",
                            type(configs["vit_base_patch16_224"])(**CFG32))
    jb = JC.build_bundle("TINY_VIT", seed=4)
    path = save_params(jb.params, str(tmp_path / "tiny_vit.npz"))
    tb = TC.build_bundle("TINY_VIT", path, device="cpu")
    assert tb.meta.num_patches == 4 and tb.meta.img_hw == 32
    assert (tb.meta.mean, tb.meta.std) == (VIT_MEAN, VIT_STD)
    x = np.random.RandomState(2).rand(2, 32, 32, 3).astype(np.float32)
    xn = np.stack([np.asarray(JC.normalize_input(a, "vit")) for a in x])
    got = torch.stack([TC.normalize_input(a, "vit", "cpu") for a in x])
    assert np.abs(got.numpy() - xn).max() <= 1e-7
    close(tb.apply(nchw(xn)).detach(), jb.apply(jb.params, jnp.asarray(xn)),
          1e-5)


@pytest.mark.parametrize("model,arch", [("VIT16", "vit_base_patch16_224"),
                                        ("VIT32", "vit_base_patch32_224"),
                                        ("TINY_VIT", "vit_tiny_patch16_224")])
def test_model_table_rows_are_xai_tpus(model, arch):
    assert TC.MODEL_TABLE[model] == JC.MODEL_TABLE[model]
    assert tvit.CONFIGS[arch] == tvit.ViTConfig(
        **dataclasses.asdict(jvit.CONFIGS[arch]))
    assert TC.family_stats("vit") == JC.family_stats("vit")


def test_init_random_is_flaxs_scheme():
    model = tvit.init_random(tvit.VisionTransformer(tvit.ViTConfig(**CFG32)),
                             seed=3)
    for name, p in model.named_parameters():
        if name.endswith("weight"):
            fan_in = p[0].numel()
            assert abs(p.std().item() * fan_in ** 0.5 - 1.0) < 0.2, name
            assert p.abs().max().item() <= 2.0 / fan_in ** 0.5 / 0.8796 + 1e-6
        elif name.endswith("scale"):
            assert torch.equal(p, torch.ones_like(p)), name
        elif name == "pos_embed":
            assert abs(p.std().item() - 0.02) < 0.004
        else:                                   # biases, cls_token
            assert torch.equal(p, torch.zeros_like(p)), name
    again = tvit.init_random(tvit.VisionTransformer(tvit.ViTConfig(**CFG32)),
                             seed=3)
    assert all(torch.equal(a, b) for a, b in
               zip(model.state_dict().values(), again.state_dict().values()))


def test_randomize_family_vit_draws_standard_normal():
    """evaluateSanity.py:108-145, vit: every parameter standard normal
    (xai_tpu_torch's CPU generator; xai_tpu's jax.random draws differ),
    deterministic in the seed, the input bundle left as it was."""
    module = tvit.init_random(tvit.VisionTransformer(tvit.ViTConfig(
        **dict(CFG32, embed_dim=64))), seed=0)
    bundle = ModelBundle(ModelMeta(name="v", family="vit", img_hw=32), module)
    before = {k: v.clone() for k, v in module.state_dict().items()}

    def draw(seed):
        return TS.randomize_family(bundle, "vit", torch.Generator()
                                   .manual_seed(seed)).module.state_dict()

    a, b, c = draw(3), draw(3), draw(4)
    assert list(a) == list(before)
    assert all(a[k].shape == before[k].shape for k in a)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["pos_embed"], c["pos_embed"])
    allv = torch.cat([v.reshape(-1) for v in a.values()])
    assert allv.numel() > 50_000
    assert abs(allv.mean().item()) < 0.02
    assert abs(allv.std().item() - 1.0) < 0.02
    assert all(torch.equal(before[k], v)
               for k, v in module.state_dict().items())
    # xai_tpu's draw: the same moments
    ref = JS.randomize_family({"w": jnp.zeros((allv.numel(),))}, "vit",
                              jax.random.PRNGKey(1))["w"]
    assert abs(float(ref.std()) - allv.std().item()) < 0.02


def test_bf16_cast_runs_in_bf16(twins):
    """The cast copy computes in bf16, LayerNorm statistics in float32
    (flax's), and its logits keep the float32 model's ranking."""
    jb, tb, x = twins
    b16 = tb.cast(torch.bfloat16)
    assert b16.extras == tb.extras and b16.module is not tb.module
    with torch.no_grad():
        l16, taps = b16.apply_taps(nchw(x).to(torch.bfloat16))
        l32 = tb.apply(nchw(x))
    assert l16.dtype == taps["attn"].dtype == torch.bfloat16
    from scipy.stats import spearmanr
    for a, b in zip(l16.float(), l32):
        assert spearmanr(a.numpy(), b.numpy()).statistic > 0.95
