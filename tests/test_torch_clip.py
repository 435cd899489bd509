"""The CLIP port, its tokenizer, text table and weight carry against
xai_tpu on the CPU.

The model is the tiny CLIP of xai_tpu's own tests (tests/test_batch_attr.py
clip_setup: patch 8, vision 32 wide, 2 blocks, 4 heads; embed 16; text 16
wide, 2 heads, 2 blocks; vocabulary 50, context 12; 32 px).  Its params,
every leaf redrawn so that the carry of each array matters, are written
with xai_tpu's save_params and read by the port's ``load_params``; the
towers, every tap, the probe gradients and the text table must match
xai_tpu's within 1e-5 of each reference's magnitude.  The build_bundle
case runs the driver-sized tiny CLIP (vocabulary 49,408, context 77) with
the real 1000-prompt table.  The helpers here build the twins of the other
CLIP test modules.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xai_tpu.data import tokenizer as JT
from xai_tpu.methods import clip_explain as JE
from xai_tpu.models import clip as jclip
from xai_tpu.models.common import ModelBundle as JBundle
from xai_tpu.models.common import ModelMeta as JMeta
from xai_tpu.ops.preprocess import CLIP_MEAN, CLIP_STD
from xai_tpu.runners import common as JC
from xai_tpu.runners import evaluate_sanity as JS
from xai_tpu.runners.common import save_params

from xai_tpu_torch.convert.from_jax import jax_leaf_name, load_params
from xai_tpu_torch.data import tokenizer as TT
from xai_tpu_torch.methods import clip_explain as TE
from xai_tpu_torch.models import clip as tclip
from xai_tpu_torch.models.common import ModelMeta
from xai_tpu_torch.runners import common as TC
from xai_tpu_torch.runners import evaluate_sanity as TS

from test_torch_vit import close, nchw
from torch_one_thread import one_torch_thread  # noqa: F401 (autouse)

# xai_tpu's test CLIP (tests/test_batch_attr.py clip_setup)
CLIP_TINY = dict(patch=8, vision_width=32, vision_layers=2, vision_heads=4,
                 embed_dim=16, text_width=16, text_heads=2, text_layers=2,
                 vocab_size=50, context_length=12, img_hw=32)
# its widths with the real vocabulary and context, for the drivers
CLIP_DRIVER = dict(CLIP_TINY, vocab_size=49408, context_length=77)
TOKS = np.array([[1, 5, 9, 49, 0, 0, 0, 0, 0, 0, 0, 0],
                 [3, 7, 49, 0, 0, 0, 0, 0, 0, 0, 0, 0],
                 [2, 4, 6, 8, 49, 0, 0, 0, 0, 0, 0, 0]], np.int32)
VIS_TAPS = ["attn", "q", "k", "v", "block_out"]


def redraw(params, rs, scale=0.05):
    """Every leaf (``logit_scale`` a scalar among them) plus ``scale``
    standard normal draws."""
    return jax.tree.map(lambda a: jnp.asarray(
        a + scale * np.asarray(rs.randn(*a.shape), np.float32)), params)


def jax_init(cfg_dict=CLIP_TINY, seed=0):
    cfg = jclip.CLIPConfig(**cfg_dict)
    return jclip.CLIP(cfg).init(
        jax.random.PRNGKey(seed), jnp.zeros((1, cfg.img_hw, cfg.img_hw, 3)),
        jnp.zeros((1, 8), jnp.int32))["params"]


def clip_twins(path, params=None, te=None, cfg_dict=CLIP_TINY):
    """(xai_tpu bundle, port bundle) of the tiny CLIP (or ``cfg_dict``):
    xai_tpu's init at PRNGKey(0) (or ``params``), carried through ``.npz``
    at ``path``, with the same ``[classes, E]`` text table ``te`` (by
    default xai_tpu's test table: 10 normal rows of PRNGKey(3),
    normalized).  xai_tpu's bundle is built as its tests build it
    (tests/test_batch_attr.py)."""
    cfg = jclip.CLIPConfig(**cfg_dict)
    model = jclip.CLIP(cfg)
    params = jax_init(cfg_dict) if params is None else params
    if te is None:
        te = jax.random.normal(jax.random.PRNGKey(3), (10, cfg.embed_dim))
        te = te / jnp.linalg.norm(te, axis=-1, keepdims=True)
    te = jnp.asarray(te)

    def encode_image(p, x):
        return model.apply({"params": p}, x,
                           method=jclip.CLIP.encode_image)[:, 0]

    meta = dict(name="smallclip", family="clip", img_hw=cfg.img_hw,
                num_patches=cfg.grid, num_classes=te.shape[0],
                mean=CLIP_MEAN, std=CLIP_STD)
    jb = JBundle(
        meta=JMeta(**meta), params=params,
        apply=jax.jit(lambda p, x: encode_image(p, x) @ te.T / 0.1),
        apply_taps=jax.jit(lambda p, x: model.apply(
            {"params": p}, x, taps=True, method=jclip.CLIP.encode_image)),
        extras={"cfg": cfg, "model": model, "text_embeddings": te,
                "encode_image": encode_image})
    save_params(params, path)
    module = tclip.CLIP(tclip.CLIPConfig(**cfg_dict))
    module.load_state_dict(load_params(path))
    tb = tclip.CLIPBundle(ModelMeta(**meta), module,
                          torch.from_numpy(np.array(te)))
    return jb, tb


@pytest.fixture(scope="module")
def twins(tmp_path_factory):
    params = redraw(jax_init(), np.random.RandomState(0))
    jb, tb = clip_twins(str(tmp_path_factory.mktemp("params") / "clip.npz"),
                        params)
    x = np.random.RandomState(1).randn(3, 32, 32, 3).astype(np.float32)
    return jb, tb, x


def _jmodel(jb):
    return jb.extras["model"]


def test_tokenizer_ids_equal_xai_tpus():
    """The 1000 class prompts, and strings that take the cleanup, the
    apostrophe rules, digits, html escapes and truncation: ids equal."""
    assert TT.imagenet_class_names() == JT.imagenet_class_names()
    assert TT.class_prompts() == JT.class_prompts()
    assert np.array_equal(tclip.class_prompt_tokens(),
                          jclip.class_prompt_tokens())
    odd = ["Hello,   World! it's 3 &amp; 4 o'clock", "", "a" * 300,
           "x-ray  \t CT scan's 12th slice", " ".join(["word"] * 90)]
    got = TT.default_tokenizer().tokenize(odd)
    assert np.array_equal(got, JT.default_tokenizer().tokenize(odd))
    assert got.dtype == np.int32 and got.shape == (len(odd), 77)


def test_tokenizer_reads_the_ports_own_files():
    root = TT.__file__.rsplit("/", 1)[0]
    assert TT.DEFAULT_BPE_PATH == f"{root}/bpe_simple_vocab_16e6.txt.gz"
    assert TT.CLASS_NAMES_PATH == f"{root}/imagenet_classes.txt"
    assert root.endswith("xai_tpu_torch/data")


def test_image_tower_matches(twins):
    jb, tb, x = twins
    ref = _jmodel(jb).apply({"params": jb.params}, jnp.asarray(x),
                            method=jclip.CLIP.encode_image)
    with torch.no_grad():
        got = tb.module.encode_image(nchw(x))
    close(got, ref, 1e-5)


def test_text_tower_matches(twins):
    jb, tb, _ = twins
    ref = _jmodel(jb).apply({"params": jb.params}, jnp.asarray(TOKS),
                            method=jclip.CLIP.encode_text)
    with torch.no_grad():
        got = tb.module.encode_text(torch.from_numpy(TOKS).long())
    close(got, ref, 1e-5)


def test_joint_logits_match(twins):
    jb, tb, x = twins
    ref = _jmodel(jb).apply({"params": jb.params}, jnp.asarray(x),
                            jnp.asarray(TOKS))
    with torch.no_grad():
        got = tb.module(nchw(x), torch.from_numpy(TOKS).long())
    close(got[0], ref[0], 1e-5)
    close(got[1], ref[1], 1e-5)


def test_bundle_apply_is_unnormalized_similarity(twins):
    """apply = encode_image[:, 0] @ te.T / 0.1, the image embedding not
    normalized (evaluatePerturbation.py:68-74)."""
    jb, tb, x = twins
    with torch.no_grad():
        close(tb.apply(nchw(x)), jb.apply(jb.params, jnp.asarray(x)), 1e-5)


@pytest.mark.parametrize("tap", VIS_TAPS)
def test_visual_taps_match(twins, tap):
    jb, tb, x = twins
    _, jt = jb.apply_taps(jb.params, jnp.asarray(x))
    with torch.no_grad():
        _, tt = tb.apply_taps(nchw(x))
    close(tt[tap], jt[tap], 1e-5)


def test_stop_before_last_is_the_last_blocks_input(twins):
    jb, tb, x = twins
    ref = _jmodel(jb).apply({"params": jb.params}, jnp.asarray(x),
                            stop_before_last=True,
                            method=jclip.CLIP.encode_image)
    with torch.no_grad():
        got = tb.module.encode_image(nchw(x), stop_before_last=True)
        _, taps = tb.apply_taps(nchw(x))
    close(got, ref, 1e-5)
    assert torch.equal(got, taps["block_out"][-2])


def test_probe_gradients_match(twins):
    """trace(logits_per_image) gradients on every visual and text
    attention probe (mm_interpret's loss), and the taps beside them."""
    jb, tb, x = twins
    cfg = jb.extras["cfg"]
    ref = JE._mm_grads(_jmodel(jb), cfg, jb.params, jnp.asarray(x),
                       jnp.asarray(TOKS))
    got = TE.mm_grads(tb, torch.from_numpy(x), torch.from_numpy(TOKS))
    for r, g in zip(ref[2:], got[2:]):
        close(g, r, 1e-5)
    close(got[0]["attn"], ref[0]["attn"], 1e-5)
    close(got[1]["attn"], ref[1]["attn"], 1e-5)


def test_zero_probes_change_nothing(twins):
    jb, tb, x = twins
    cfg = tb.extras["cfg"]
    probes = tclip.zero_probes(cfg, "visual", 3)
    assert probes["attn"].shape == (2, 3, 4, 17, 17)
    assert tclip.zero_probes(cfg, "text", 2, seq=5)["attn"].shape == \
        (2, 2, 2, 5, 5)
    with torch.no_grad():
        got, _ = tb.apply_probed(nchw(x), probes)
        assert torch.equal(got, tb.module.encode_image(nchw(x)))


def test_text_table_matches(twins):
    """attach_text_table: the ids encoded in chunks (xai_tpu's of 3, the
    port's of 125), normalized, within 1e-5 of xai_tpu's; the ids kept;
    apply rebound to the table."""
    jb, tb, x = twins
    toks = np.random.RandomState(5).randint(1, 49, (7, 12)).astype(np.int32)
    toks[:, 6] = 49                                 # EOT, the largest id
    ja = jclip.attach_text_table(jb, tokens=toks, chunk=3)
    ta = tclip.attach_text_table(tb, tokens=toks)
    close(ta.text_embeddings, ja.extras["text_embeddings"], 1e-5)
    assert ta.text_embeddings.dtype == torch.float32
    assert np.array_equal(ta.extras["text_tokens_table"].numpy(), toks)
    assert ta.meta.num_classes == 7 and ta.module is tb.module
    with torch.no_grad():
        close(ta.apply(nchw(x)), ja.apply(ja.params, jnp.asarray(x)), 1e-5)


def test_cast_keeps_the_float32_text_table(twins):
    """The bf16 copy shares the float32 table and returns float32 logits
    (xai_tpu's apply closure keeps te float32); the float32 bundle is
    untouched."""
    _, tb, x = twins
    before = tb.apply(nchw(x))
    b16 = tb.cast(torch.bfloat16)
    assert isinstance(b16, tclip.CLIPBundle) and b16.dtype == torch.bfloat16
    assert b16.text_embeddings is tb.text_embeddings
    with torch.no_grad():
        got = b16.apply(nchw(x).to(torch.bfloat16))
    assert got.dtype == torch.float32
    assert (got - before).abs().max() < 0.2 * before.abs().max()
    assert torch.equal(tb.apply(nchw(x)), before)
    assert tb.dtype == torch.float32


def test_weight_carry_layouts(twins):
    """conv1 HWIO -> OIHW, the dense kernels [in, out] -> [out, in];
    proj, text_projection, token_embedding, both positional embeddings,
    class_embedding, the LayerNorms and logit_scale as they are."""
    jb, tb, _ = twins
    state = tb.module.state_dict()
    flat = {"/".join(str(getattr(k, "key", k)) for k in kp): np.asarray(v)
            for kp, v in jax.tree_util.tree_flatten_with_path(jb.params)[0]}
    assert len(flat) == len(state)
    for name, got in state.items():
        ref = flat[jax_leaf_name(name)]
        if name.endswith(".weight") and ref.ndim == 4:
            ref = ref.transpose(3, 2, 0, 1)
        elif name.endswith(".weight"):
            ref = ref.T
        assert np.array_equal(got.numpy(), ref), name
    assert state["visual.proj"].shape == (32, 16)
    assert state["text.text_projection"].shape == (16, 16)
    assert state["logit_scale"].dim() == 0


def test_clip_carries_through_build_bundle(tmp_path, monkeypatch):
    """--model CLIP16 --params_path: one xai_tpu .npz serves both
    packages' build_bundle (the driver-sized tiny CLIP in both
    constructors); the real 1000-prompt table is built by each package's
    text tower after the weights are in: ids equal, embeddings and logits
    within 1e-5."""
    for configs, cls in ((jclip.CONFIGS, jclip.CLIPConfig),
                         (tclip.CONFIGS, tclip.CLIPConfig)):
        monkeypatch.setitem(configs, "clip_vit_b16", cls(**CLIP_DRIVER))
    jb = JC.build_bundle("CLIP16", seed=4)
    path = save_params(jb.params, str(tmp_path / "clip16.npz"))
    tb = TC.build_bundle("CLIP16", path, device="cpu")
    assert isinstance(tb, tclip.CLIPBundle)
    assert tb.meta.num_patches == 4 and tb.meta.img_hw == 32
    assert (tb.meta.mean, tb.meta.std) == (CLIP_MEAN, CLIP_STD)
    assert tb.meta.family == "clip" and tb.meta.batch_size == 25
    assert tb.text_embeddings.shape == (1000, 16)
    assert np.array_equal(tb.text_tokens.numpy(),
                          np.asarray(jb.extras["text_tokens_table"]))
    close(tb.text_embeddings, jb.extras["text_embeddings"], 1e-5)
    x = np.random.RandomState(2).rand(2, 32, 32, 3).astype(np.float32)
    xn = np.stack([np.asarray(JC.normalize_input(a, "clip")) for a in x])
    got = torch.stack([TC.normalize_input(a, "clip", "cpu") for a in x])
    assert np.abs(got.numpy() - xn).max() <= 1e-7
    with torch.no_grad():
        close(tb.apply(nchw(xn)), jb.apply(jb.params, jnp.asarray(xn)),
              1e-5)
    ex = TC.clip_extras(tb, 7)
    ref = JC.clip_extras(jb, 7)
    close(ex["txt_emb"], ref["txt_emb"], 1e-5)
    assert np.array_equal(ex["text_tokens"].numpy(),
                          np.asarray(ref["text_tokens"]))


@pytest.mark.parametrize("model,arch", [("CLIP16", "clip_vit_b16"),
                                        ("CLIP32", "clip_vit_b32")])
def test_model_table_rows_are_xai_tpus(model, arch):
    assert TC.MODEL_TABLE[model] == JC.MODEL_TABLE[model]
    assert tclip.CONFIGS[arch] == tclip.CLIPConfig(
        **dataclasses.asdict(jclip.CONFIGS[arch]))
    assert tclip.CLI_ARCH[model] == jclip.CLI_ARCH[model] == arch
    assert TC.family_stats("clip") == JC.family_stats("clip")


def test_full_width_shapes():
    """CLIP16 at xai_tpu's full width: 197 visual tokens, 86.2 M visual
    and 63.4 M text parameters (openai ViT-B/16's 149.6 M in all)."""
    model = tclip.CLIP(tclip.CONFIGS["clip_vit_b16"])
    n_vis = sum(p.numel() for p in model.visual.parameters())
    n_txt = sum(p.numel() for p in model.text.parameters())
    assert model.cfg.tokens == 197 and model.cfg.grid == 14
    assert tclip.CONFIGS["clip_vit_b32"].tokens == 50
    assert n_vis == 86_192_640 and n_txt == 63_428_096


def test_init_random_is_flaxs_scheme():
    model = tclip.init_random(tclip.CLIP(tclip.CLIPConfig(
        **dict(CLIP_TINY, vision_width=64))), seed=3)
    sd = {"visual.class_embedding": 0.02,
          "visual.positional_embedding": 0.02, "visual.proj": 0.02,
          "text.token_embedding": 0.02, "text.positional_embedding": 0.01,
          "text.text_projection": 0.02}
    for name, p in model.named_parameters():
        if name in sd:
            assert abs(p.std().item() - sd[name]) < 0.35 * sd[name], name
        elif name.endswith("weight"):
            fan_in = p[0].numel()
            assert abs(p.std().item() * fan_in ** 0.5 - 1.0) < 0.25, name
        elif name == "logit_scale":
            assert p.item() == pytest.approx(4.6052)
        elif name.endswith("scale"):
            assert torch.equal(p, torch.ones_like(p)), name
        else:                                   # biases
            assert torch.equal(p, torch.zeros_like(p)), name
    again = tclip.init_random(tclip.CLIP(tclip.CLIPConfig(
        **dict(CLIP_TINY, vision_width=64))), seed=3)
    assert all(torch.equal(a, b) for a, b in
               zip(model.state_dict().values(), again.state_dict().values()))


def test_randomize_family_clip_follows_xai_tpus_rule_by_name(
        tmp_path, twins):
    """evaluateSanity.py:108-145, clip, name by name: the parameters the
    port redraws, zeroes and keeps are the images of the leaves that
    xai_tpu's randomize_family redraws, zeroes and keeps on the same
    weights; the redraws are standard normal; the text table is rebuilt
    with the randomized text tower."""
    jb, tb, _ = twins
    rand = JS.randomize_family(jb.params, "clip", jax.random.PRNGKey(1))
    flat = lambda t: {"/".join(str(getattr(k, "key", k)) for k in kp):
                      np.asarray(v) for kp, v in
                      jax.tree_util.tree_flatten_with_path(t)[0]}
    before, after = flat(jb.params), flat(rand)

    def kind(a, b):
        return ("keep" if np.array_equal(a, b) else
                "zero" if not b.any() else "normal")

    want = {k: kind(before[k], after[k]) for k in before}
    assert set(want.values()) == {"keep", "zero", "normal"}
    bundle = tclip.attach_text_table(tb, tokens=TOKS)
    got_b = TS.randomize_family(bundle, "clip",
                                torch.Generator().manual_seed(2))
    old = bundle.module.state_dict()
    new = got_b.module.state_dict()
    got = {jax_leaf_name(k): kind(old[k].numpy(), new[k].numpy())
           for k in old}
    assert got == want
    drawn = torch.cat([new[k].reshape(-1) for k in new
                       if got[jax_leaf_name(k)] == "normal"])
    assert abs(drawn.mean().item()) < 0.05
    assert abs(drawn.std().item() - 1.0) < 0.05
    assert torch.equal(got_b.text_tokens, bundle.text_tokens)
    close(got_b.text_embeddings, tclip.encode_text_table(
        got_b.module, bundle.text_tokens), 1e-6)
    assert not torch.allclose(got_b.text_embeddings, bundle.text_embeddings)
    assert torch.equal(bundle.module.state_dict()["text.token_embedding"],
                       old["text.token_embedding"])
