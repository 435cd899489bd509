"""The 12 CLIP explainers of xai_tpu_torch against xai_tpu on the CPU.

xai_tpu's tiny test CLIP (``test_torch_clip.CLIP_TINY``) at its init, with
xai_tpu's 10-class test text table and token rows
(tests/test_batch_attr.py clip_setup), carried through ``.npz``.  Each
registry entry must be within 1e-4 of the CPU map's max of xai_tpu's;
m2ib takes xai_tpu's noise draws and rise its masks (``noises=``,
``masks=``), and surgery the same text table.  The batched form of each
of the 11 batched names must equal its single runs (every reduction is
per image) and xai_tpu's ``batch_attribution``.  bf16 is held to a rank
contract against the port's own float32 (Spearman rho > 0.95 per image),
and its dtypes to what xai_tpu's bf16 path computes in.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xai_tpu.methods import batch as JBT
from xai_tpu.methods import clip_explain as JE
from xai_tpu.methods import clip_m2ib as JI
from xai_tpu.methods import clip_surgery as JS
from xai_tpu.methods import rise as JR
from xai_tpu.registry import AttrContext as JCtx
from xai_tpu.registry import get_attribution as jax_attr

from xai_tpu_torch.methods import batch as TBT
from xai_tpu_torch.methods import clip_explain as TE
from xai_tpu_torch.methods import clip_m2ib as TI
from xai_tpu_torch.methods import clip_surgery as TS
from xai_tpu_torch.methods import rise as TR
from xai_tpu_torch.ops.stats import spearman_np
from xai_tpu_torch.registry import AttrContext, get_attribution

from test_torch_clip import CLIP_TINY, TOKS, clip_twins
from torch_one_thread import one_torch_thread  # noqa: F401 (autouse)

B = 3
TARGETS = np.array([0, 5, 9])
BATCHED = list(TBT.CLIP_EXTRA_KIND)
# the registry names that draw nothing
DRAW_FREE = [n for n in BATCHED if n != "m2ib"]


def near(got, ref, rel=1e-4):
    """Max |delta| within ``rel`` of the reference map's max."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    scale = float(np.abs(ref).max())
    assert scale > 0
    err = float(np.abs(got - ref).max())
    assert err <= rel * scale, (err, scale)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    jb, tb = clip_twins(str(tmp_path_factory.mktemp("params") / "clip.npz"))
    xs = np.random.RandomState(4).randn(B, 32, 32, 3).astype(np.float32)
    te = np.asarray(jb.extras["text_embeddings"])
    extras = {"txt_emb": te[TARGETS], "text_tokens": TOKS}
    keys = np.stack([np.asarray(jax.random.fold_in(jax.random.PRNGKey(2), i))
                     for i in range(B)])
    return jb, tb, xs, extras, keys


def _row_extras(extras, i, torch_side):
    ex = {k: v[i:i + 1] for k, v in extras.items()}
    return {k: torch.from_numpy(v) for k, v in ex.items()} if torch_side \
        else ex


def _t_extras(extras):
    return {k: torch.from_numpy(v) for k, v in extras.items()}


def _jax_m2ib_noise(key, cfg, steps=10, rows=10):
    """xai_tpu's per-image m2ib draws of ``key`` (its batched adapter's
    and vision_heatmap_iba's: one split a step)."""
    keys = jax.random.split(jnp.asarray(key), steps)
    return np.asarray(jax.vmap(lambda k: jax.random.normal(
        k, (rows, cfg.tokens, cfg.vision_width)))(keys))


@pytest.mark.parametrize("name", DRAW_FREE)
def test_registry_entry_matches_xai_tpu(setup, name):
    jb, tb, xs, extras, keys = setup
    for i in range(B):
        ref = jax_attr("clip", name, JCtx(
            bundle=jb, x=jnp.asarray(xs[i]), trans_img=xs[i],
            target=int(TARGETS[i]), key=jnp.asarray(keys[i]), img_hw=32,
            extras=_row_extras(extras, i, False)))
        got = get_attribution("clip", name, AttrContext(
            bundle=tb, x=torch.from_numpy(xs[i]), trans_img=xs[i],
            target=int(TARGETS[i]), img_hw=32,
            extras=_row_extras(extras, i, True)))
        assert got.shape == (32, 32) and got.dtype == np.float32
        near(got, ref)


@pytest.mark.parametrize("vlayer", [0, 9])
def test_m2ib_matches_xai_tpu_on_its_noise(setup, vlayer):
    """vlayer 0 runs a one-block suffix; the registry's 9 is past the tiny
    model's last block, where xai_tpu's tap index clamps and the suffix is
    empty (the port's slices give the same)."""
    jb, tb, xs, extras, keys = setup
    cfg = jb.extras["cfg"]
    noises = np.stack([_jax_m2ib_noise(k, cfg) for k in keys])
    got = TI.vision_heatmap_iba(tb, torch.from_numpy(xs),
                                torch.from_numpy(extras["txt_emb"]),
                                vlayer=vlayer, noises=noises)
    for i in range(B):
        ref = JI.vision_heatmap_iba(jb, xs[i], extras["txt_emb"][i:i + 1],
                                    vlayer=vlayer, noises=noises[i])
        near(got[i], ref)


def test_m2ib_registry_entry_draws_from_the_images_generator(setup):
    jb, tb, xs, extras, _ = setup
    cfg = tb.extras["cfg"]
    got = get_attribution("clip", "m2ib", AttrContext(
        bundle=tb, x=torch.from_numpy(xs[1]), trans_img=xs[1], target=5,
        img_hw=32, generator=torch.Generator().manual_seed(11),
        extras=_row_extras(extras, 1, True)))
    noise = TI.m2ib_noise(torch.Generator().manual_seed(11), cfg.tokens,
                          cfg.vision_width)
    want = TI.vision_heatmap_iba(tb, torch.from_numpy(xs[1:2]),
                                 torch.from_numpy(extras["txt_emb"][1:2]),
                                 noises=noise[None]).abs()
    assert np.array_equal(got, want[0].numpy())
    assert got.min() == 0.0 and got.max() == 1.0


def test_rise_matches_xai_tpu_on_its_masks(setup):
    """CLIP's rise scores the bundle's similarity logits' softmax (the
    CNN entry's method); injected masks, both packages."""
    jb, tb, xs, _, _ = setup
    masks = np.random.RandomState(6).rand(40, 32, 32).astype(np.float32)
    ref = JR.rise(jb, xs[0], 5, None, masks=masks)
    got = TR.rise(tb, torch.from_numpy(xs[0]), 5, masks=masks)
    near(got, ref)
    g = torch.Generator().manual_seed(3)
    entry = get_attribution("clip", "rise", AttrContext(
        bundle=tb, x=torch.from_numpy(xs[0]), trans_img=xs[0], target=5,
        img_hw=32, generator=g, extras=_row_extras(setup[3], 0, True)))
    want = TR.rise(tb, torch.from_numpy(xs[0]), 5,
                   torch.Generator().manual_seed(3)).abs()
    assert np.array_equal(entry, want.numpy())


def test_lrp_text_relevance_matches(setup):
    jb, tb, xs, _, _ = setup
    r_txt, r_img = TE.clip_lrp(tb, torch.from_numpy(xs),
                               torch.from_numpy(TOKS))
    for i in range(B):
        ref_txt, ref_img = JE.clip_lrp(jb, xs[i], TOKS[i:i + 1])
        near(r_txt[i], ref_txt[0])
        near(r_img[i], ref_img)


@pytest.mark.parametrize("n_classes,targets", [
    (10, [0, 5, 9]), (1000, [0, 58, 59, 500])])
def test_surgery_text_table_is_xai_tpus(n_classes, targets):
    """The target's caption, then the first other classes in index order:
    xai_tpu's registry entry (a list) and batched adapter (an index
    formula) agree, and the port with both."""
    te = torch.randn(n_classes, 4, generator=torch.Generator().manual_seed(0))

    class Bundle:
        extras = {"text_embeddings": te}

    got = TS.surgery_text_table(Bundle, targets)
    for row, t in zip(got, targets):
        others = [i for i in range(min(60, n_classes)) if i != t][:59]
        assert torch.equal(row, te[[t] + others])


def test_surgery_feature_steps_match(setup):
    """The dual-path features and the feature surgery, each against
    xai_tpu's, on the same text table."""
    jb, tb, xs, _, _ = setup
    feats = JS._surgery_encode(jb.extras["model"], jb.extras["cfg"],
                               jb.params, jnp.asarray(xs))
    got = TS.surgery_encode(tb, torch.from_numpy(xs))
    near(got, feats, 1e-5)
    table = TS.surgery_text_table(tb, TARGETS)
    for i in range(B):
        ref = JS.clip_feature_surgery(feats[i:i + 1],
                                      jnp.asarray(table[i].numpy()))
        near(TS.clip_feature_surgery(got[i:i + 1], table[i:i + 1]), ref,
             1e-5)


@pytest.mark.parametrize("name", BATCHED)
def test_batch_matches_single_and_xai_tpu(setup, name):
    """batch_attribution of the 11 batched names: each row is its image's
    registry entry (same generator for m2ib), and xai_tpu's batched map
    (m2ib: the port's bottleneck on xai_tpu's draws from its keys)."""
    jb, tb, xs, extras, keys = setup
    gens = [torch.Generator().manual_seed(20 + i) for i in range(B)]
    got = TBT.batch_attribution("clip", name, tb, torch.from_numpy(xs), xs,
                                TARGETS, gens, img_hw=32,
                                extras=_t_extras(extras))
    assert got.shape == (B, 32, 32) and got.dtype == np.float32
    for i in range(B):
        single = get_attribution("clip", name, AttrContext(
            bundle=tb, x=torch.from_numpy(xs[i]), trans_img=xs[i],
            target=int(TARGETS[i]), img_hw=32,
            generator=torch.Generator().manual_seed(20 + i),
            extras=_row_extras(extras, i, True)))
        near(got[i], single, 1e-5)
    ref = JBT.batch_attribution("clip", name, jb, xs, xs, TARGETS, keys,
                                extras=extras, img_hw=32)
    if name == "m2ib":
        cfg = jb.extras["cfg"]
        got = TI.vision_heatmap_iba(
            tb, torch.from_numpy(xs), torch.from_numpy(extras["txt_emb"]),
            noises=np.stack([_jax_m2ib_noise(k, cfg) for k in keys])).abs()
    for i in range(B):
        near(got[i], ref[i])


def test_batch_needs_the_extras_its_name_takes(setup):
    _, tb, xs, extras, _ = setup
    with pytest.raises(ValueError, match="txt_emb"):
        TBT.batch_attribution("clip", "eclip", tb, torch.from_numpy(xs), xs,
                              TARGETS, None, img_hw=32,
                              extras={"text_tokens": torch.from_numpy(TOKS)})
    with pytest.raises(ValueError, match="text_tokens"):
        TBT.batch_attribution("clip", "game", tb, torch.from_numpy(xs), xs,
                              TARGETS, None, img_hw=32, extras=None)
    got = TBT.batch_attribution("clip", "selfattn", tb, torch.from_numpy(xs),
                                xs, TARGETS, None, img_hw=32)
    assert got.shape == (B, 32, 32)
    assert TBT.batch_attribution("clip", "rise", tb, torch.from_numpy(xs),
                                 xs, TARGETS, None, img_hw=32,
                                 extras=_t_extras(extras)) is None


@pytest.fixture(scope="module")
def setup64(tmp_path_factory):
    """The tiny CLIP's widths at 64 px: an 8 x 8 patch grid."""
    jb, tb = clip_twins(str(tmp_path_factory.mktemp("params") / "c64.npz"),
                        cfg_dict=dict(CLIP_TINY, img_hw=64))
    xs = np.random.RandomState(4).randn(B, 64, 64, 3).astype(np.float32)
    te = np.asarray(jb.extras["text_embeddings"])
    return tb, xs, {"txt_emb": te[TARGETS], "text_tokens": TOKS}


@pytest.mark.parametrize("name", BATCHED)
def test_bf16_rank_contract(setup64, name):
    """--attr_dtype bf16 on the batched path: Spearman rho > 0.95 per image
    against the port's own float32 maps.  At 64 px: at 32 px a map has 16
    patches, and one near-zero patch that bf16 rounds across relu's kink
    moves a whole sixteenth of the map's ranks (eclip_nograd falls below
    0.95 on one image there)."""
    tb, xs, extras = setup64
    run = lambda dtype: TBT.batch_attribution(
        "clip", name, tb, torch.from_numpy(xs), xs, TARGETS,
        [torch.Generator().manual_seed(i) for i in range(B)], img_hw=64,
        dtype=dtype, extras=_t_extras(extras))
    f32, b16 = run(None), run(torch.bfloat16)
    assert b16.dtype == np.float32 and np.isfinite(b16).all()
    rho = [spearman_np(a, b) for a, b in zip(f32, b16)]
    assert min(rho) > 0.95, rho


def _jax_maps(jb, xs, extras, keys):
    """xai_tpu's batched adapters' raw maps, before resize and abs, on a
    bf16 copy of the params, with bf16 captions (its batch_attribution's
    casts)."""
    m, cfg = jb.extras["model"], jb.extras["cfg"]
    p = jax.tree.map(lambda a: a.astype(jnp.bfloat16), jb.params)
    x = jnp.asarray(xs[:1]).astype(jnp.bfloat16)
    e = jnp.asarray(extras["txt_emb"][:1]).astype(jnp.bfloat16)
    tok = jnp.asarray(TOKS[:1])
    noise = jnp.asarray(_jax_m2ib_noise(keys[0], cfg))
    return {
        "eclip": JE._grad_eclip_jit(m, cfg, True, True, p, x, e),
        "eclip_nograd": JE._grad_eclip_jit(m, cfg, True, False, p, x, e),
        "eclip_wo": JE._grad_eclip_jit(m, cfg, False, True, p, x, e),
        "maskclip": JE._mask_clip_jit(m, cfg, p, x, e),
        "selfattn": JE._self_attn_jit(m, cfg, p, x),
        "grad_cam": JE._clip_grad_cam_jit(m, cfg, p, x, e),
        "game": JE._game_jit(m, cfg, cfg.vision_layers - 1, p, x, tok),
        "lrp": JE._clip_lrp_jit(m, cfg, 0, 0, p, x, tok)[1],
        "rollout": (jb.apply_taps(p, x)[1]["attn"][-1].mean(axis=1)
                    + jnp.eye(cfg.tokens)),
        "surgery": JS._surgery_map_jit(
            m, cfg, p, x, jnp.asarray(jb.extras["text_embeddings"])),
        "m2ib": JI._iba_jit(m, cfg, 9, 10, 0.1, 1.0, 32, p, x, e, noise),
    }


def test_bf16_computes_in_xai_tpus_dtypes(setup):
    """What xai_tpu's bf16 path really computes in, checked on the CPU:
    the dense block's float32 attention and tail, bf16 values, keys and
    value path; float32 probe gradients (its float32 zero probes) and
    relevance; bf16 maskclip and grad_cam; float32 surgery similarity and
    rollout (its float32 eye).  The port's bf16 maps and intermediates
    have the same dtypes, but m2ib's: xai_tpu's capacity is bf16 through
    its weakly typed alpha, the port's float32 (a recorded deviation,
    methods/clip_m2ib.py)."""
    jb, tb, xs, extras, keys = setup
    want = {k: jnp.dtype(v.dtype).name for k, v in
            _jax_maps(jb, xs, extras, keys).items()}
    b16 = tb.cast(torch.bfloat16)
    x = torch.from_numpy(xs[:1])
    ex = {"txt_emb": torch.from_numpy(extras["txt_emb"][:1]).bfloat16(),
          "text_tokens": torch.from_numpy(TOKS[:1])}
    got = {n: fn(b16, x, ex).dtype for n, fn in TBT.CLIP_PATCH_MAPS.items()}
    got["surgery"] = TS.surgery_map(b16, x,
                                    TS.surgery_text_table(b16, [0])).dtype
    got["m2ib"] = TI.vision_heatmap_iba(b16, x, ex["txt_emb"],
                                        generators=[torch.Generator()]).dtype
    assert want.pop("m2ib") == "bfloat16"
    assert got.pop("m2ib") == torch.float32
    assert {k: str(v).replace("torch.", "") for k, v in got.items()} == want
    d = TE.encode_dense(b16, x)
    jd = JE._encode_dense_jit(jb.extras["model"], jb.extras["cfg"],
                              jax.tree.map(lambda a: a.astype(jnp.bfloat16),
                                           jb.params),
                              jnp.asarray(xs[:1]).astype(jnp.bfloat16))
    for field in TE.DenseOutputs._fields:
        assert str(getattr(d, field).dtype).replace("torch.", "") == \
            jnp.dtype(getattr(jd, field).dtype).name, field
    _, _, gv, gt = TE.mm_grads(b16, x, ex["text_tokens"])
    assert gv.dtype == gt.dtype == torch.float32


def test_explainers_take_each_reduction_per_image(setup):
    """A batch of one image twice and another gives the lone image's rows:
    grad_eclip's min-max, Grad-CAM's token mean and the relevance chain
    see one image at a time."""
    _, tb, xs, extras, _ = setup
    x = torch.from_numpy(xs)
    txt = torch.from_numpy(extras["txt_emb"])
    tok = torch.from_numpy(TOKS)
    for fn in (lambda a, t, k: TE.grad_eclip(tb, a, t),
               lambda a, t, k: TE.clip_grad_cam(tb, a, t),
               lambda a, t, k: TE.game(tb, a, k)):
        both = fn(x[:2], txt[:2], tok[:2])
        alone = fn(x[1:2], txt[1:2], tok[1:2])
        near(both[1], alone[0], 1e-6)


def test_m2ib_bf16_capacity_is_float32(setup):
    """The recorded deviation: at the registry's vlayer (9, past the tiny
    model's last block, so the bottleneck sits on the last block's
    output) xai_tpu's bf16 m2ib computes its capacity in bf16 (its
    weakly typed alpha) and its map ranks unlike its float32 one; the
    port's float32 capacity keeps rho > 0.95 on the same noise."""
    from scipy.stats import spearmanr

    jb, tb, xs, extras, keys = setup
    m, cfg = jb.extras["model"], jb.extras["cfg"]
    p16 = jax.tree.map(lambda a: a.astype(jnp.bfloat16), jb.params)
    b16 = tb.cast(torch.bfloat16)
    rho_jax, rho_port = [], []
    for i in range(B):
        noise = _jax_m2ib_noise(keys[i], cfg)
        txt = extras["txt_emb"][i:i + 1]
        f32 = np.asarray(JI._iba_jit(m, cfg, 9, 10, 0.1, 1.0, 32, jb.params,
                                     jnp.asarray(xs[i:i + 1]),
                                     jnp.asarray(txt), jnp.asarray(noise)))
        bf = np.asarray(JI._iba_jit(
            m, cfg, 9, 10, 0.1, 1.0, 32, p16,
            jnp.asarray(xs[i:i + 1]).astype(jnp.bfloat16),
            jnp.asarray(txt).astype(jnp.bfloat16),
            jnp.asarray(noise)).astype(jnp.float32))
        rho_jax.append(spearmanr(f32.ravel(), bf.ravel()).statistic)
        x = torch.from_numpy(xs[i:i + 1])
        got = [TI.vision_heatmap_iba(bundle, x, torch.from_numpy(txt).to(dt),
                                     noises=noise[None]).float().numpy()
               for bundle, dt in ((tb, torch.float32),
                                  (b16, torch.bfloat16))]
        rho_port.append(spearman_np(*got))
    assert min(rho_jax) < 0.9, rho_jax
    assert min(rho_port) > 0.95, rho_port
