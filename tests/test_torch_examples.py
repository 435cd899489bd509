"""The port's three walkthroughs against xai_tpu's functions, on the CPU.

Each walkthrough's ``run`` goes through the port on small models (TINY_R
at 32 px, a 5-block variant of xai_tpu's 32 px test ViT, so that
bidirectional's start layer 4 weights a block, and xai_tpu's tiny CLIP),
and the same weights, carried through ``save_params`` -> ``load_params``,
go through the xai_tpu functions that xai_tpu's walkthroughs call, on the
same inputs: maps within 1e-4 of the reference's largest, battery scores
within 2e-3.  Each ``main`` runs on an image file written here (a
non-square RGB JPEG, which the resize and crop change), through
``load_and_preprocess``, against xai_tpu's on its ``load_and_preprocess``
of the same file; an ``L`` image ends the run, as the reference skips it.
"""
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from xai_tpu.methods import clip_explain as JE
from xai_tpu.methods import gradient as JG
from xai_tpu.methods import vit_explain as JV
from xai_tpu.methods.mda import mda as jax_mda
from xai_tpu.metrics import run_battery as jax_run_battery
from xai_tpu.models import clip as jclip
from xai_tpu.models import vit as jvit
from xai_tpu.ops import make_blur_fn as jax_blur
from xai_tpu.ops.preprocess import CLIP_MEAN, CLIP_STD, IMAGENET_MEAN, \
    IMAGENET_STD, VIT_MEAN, VIT_STD
from xai_tpu.ops.preprocess import load_and_preprocess as jax_load
from xai_tpu.ops.resize import resize_bilinear as jax_resize
from xai_tpu.runners import common as JC

from xai_tpu_torch.examples import clip_example, cnn_example, vit_example
from xai_tpu_torch.models import clip as tclip
from xai_tpu_torch.models import vit as tvit
from xai_tpu_torch.runners.common import build_bundle

from test_torch_clip import CLIP_DRIVER, TOKS, clip_twins
from test_torch_vit import CFG32, close, redraw, tiny_vit_twins
from torch_one_thread import one_torch_thread  # noqa: F401 (autouse)

STEPS = cnn_example.STEPS
# the 32 px test ViT, 5 blocks deep
CFG_VIT5 = dict(CFG32, depth=5)
MDA_PATCHES = 16
SCORE_TOL = 2e-3


def write_jpeg(path, mode="RGB", w=400, h=300, seed=0) -> str:
    rgb = (np.random.RandomState(seed).rand(h, w, 3) * 255).astype(np.uint8)
    Image.fromarray(rgb, "RGB").convert(mode).save(
        path, "JPEG" if mode == "RGB" else "PNG")
    return str(path)


# --- xai_tpu's side: the calls of its walkthroughs ---

def jax_cnn(jb, x, steps=STEPS) -> dict:
    x = jnp.asarray(x)
    target, _ = jb.predict(x[None])
    attrs = {"grad": JG.grad(jb, x, target),
             "ig": JG.ig(jb, x, target, steps=steps),
             "lig": JG.ig(jb, x, target, steps=steps, alpha_star=0.9),
             "idg": JG.idg(jb, x, target, steps=steps)}
    out = {}
    for name, attr in attrs.items():
        sal = np.asarray(JG.to_saliency(attr))
        out[name] = (sal, jax_run_battery(jb.apply, jb.params, np.asarray(x),
                                          sal, jax_blur()))
    return out


def jax_vit(jb, x, trans_img, with_mda, patch_count) -> dict:
    x = jnp.asarray(x)
    target = int(jnp.argmax(jb.apply(jb.params, x[None])[0]))
    hw = (jb.meta.img_hw, jb.meta.img_hw)
    maps = {"raw attn": JV.raw_attn(jb, x), "rollout": JV.rollout(jb, x),
            "t_attn": JV.transition_attention(jb, x, target),
            "bi_attn": JV.bidirectional(jb, x, target),
            "InFlow": JV.rave(jb, x, target)}
    out = {k: np.abs(np.asarray(jax_resize(m, hw))) for k, m in maps.items()}
    if with_mda:
        prior3 = np.repeat(np.asarray(jax_resize(maps["bi_attn"], hw))[
            ..., None], 3, -1)
        out["MDA"] = jax_mda(jb, trans_img, x, prior3, patch_count,
                             jax_blur(), target=target)
    return out


def jax_clip(jb, x, txt, tokens) -> dict:
    x = jnp.asarray(x)
    return {"grad_eclip": JE.grad_eclip(jb, x, txt),
            "maskclip": JE.mask_clip(jb, x, txt),
            "selfattn": JE.self_attn(jb, x),
            "game": JE.game(jb, x, jnp.asarray(tokens, jnp.int32))}


def hold_cnn(got, want):
    assert list(got) == list(want)
    for name, (sal, scores) in got.items():
        ref_sal, ref_scores = want[name]
        assert sal.shape == ref_sal.shape
        close(sal, ref_sal, 1e-4)
        assert list(scores) == list(ref_scores)
        for k, v in scores.items():
            assert np.isfinite(v) and abs(v - ref_scores[k]) < SCORE_TOL, \
                (name, k, v, ref_scores[k])


def hold_maps(got, want):
    assert list(got) == list(want)
    for name, m in got.items():
        assert m.shape == np.shape(want[name]), name
        close(m, want[name], 1e-4)


# --- the CNN walkthrough ---

@pytest.fixture(scope="module")
def cnn_params(tmp_path_factory):
    jb = JC.build_bundle("TINY_R", seed=5)
    path = str(tmp_path_factory.mktemp("params") / "tiny_r.npz")
    JC.save_params(jb.params, path)
    return jb, path


def test_cnn_run_matches_xai_tpu(cnn_params):
    jb, path = cnn_params
    tb = build_bundle("TINY_R", path, device="cpu")
    x = np.random.RandomState(2).randn(32, 32, 3).astype(np.float32)
    got = cnn_example.run(tb, torch.from_numpy(x))
    assert list(got) == ["grad", "ig", "lig", "idg"]
    hold_cnn(got, jax_cnn(jb, x))


def test_cnn_main_on_an_image_file(cnn_params, tmp_path, capsys):
    jb, path = cnn_params
    jpg = write_jpeg(tmp_path / "in.jpg")
    png = str(tmp_path / "panel.png")
    got = cnn_example.main(["--image", jpg, "--params", path, "--model",
                            "TINY_R", "--out", png, "--device", "cpu"])
    _, x = jax_load(jpg, 64, IMAGENET_MEAN, IMAGENET_STD)
    hold_cnn(got, jax_cnn(jb, x[0]))
    out = capsys.readouterr().out
    assert out.count("MAS_ins=") == 4 and f"wrote {png}" in out
    assert Image.open(png).size == (1500, 300)


def test_cnn_main_without_matplotlib_says_so(cnn_params, tmp_path,
                                             monkeypatch, capsys):
    _, path = cnn_params
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    png = str(tmp_path / "panel.png")
    cnn_example.main(["--params", path, "--model", "TINY_R", "--out", png,
                      "--device", "cpu"])
    assert "the panel" in capsys.readouterr().out
    assert not (tmp_path / "panel.png").exists()


# --- the ViT walkthrough ---

@pytest.fixture(scope="module")
def vit5(tmp_path_factory):
    model = jvit.VisionTransformer(jvit.ViTConfig(**CFG_VIT5))
    params = redraw(model.init(jax.random.PRNGKey(0),
                               jnp.zeros((1, 32, 32, 3)))["params"],
                    np.random.RandomState(0))
    path = str(tmp_path_factory.mktemp("params") / "vit5.npz")
    return tiny_vit_twins(path, params, cfg=CFG_VIT5)


def test_vit_run_matches_xai_tpu(vit5):
    jb, tb = vit5
    x = np.random.RandomState(2).randn(32, 32, 3).astype(np.float32)
    trans = np.random.RandomState(3).rand(32, 32, 3).astype(np.float32)
    got = vit_example.run(tb, torch.from_numpy(x), trans, with_mda=True,
                          patch_count=MDA_PATCHES)
    assert list(got)[-1] == "MDA"
    assert float(np.abs(got["bi_attn"]).max()) > 0
    hold_maps(got, jax_vit(jb, x, trans, True, MDA_PATCHES))


@pytest.fixture()
def vit16_tiny(monkeypatch):
    """The 5-block test ViT in both packages' VIT16 constructor (1000
    classes, as the constructors give it)."""
    cfg = dict(CFG_VIT5, num_classes=1000)
    for configs, cls in ((jvit.CONFIGS, jvit.ViTConfig),
                         (tvit.CONFIGS, tvit.ViTConfig)):
        monkeypatch.setitem(configs, "vit_base_patch16_224", cls(**cfg))


def test_vit_main_on_an_image_file(vit16_tiny, tmp_path):
    jb = JC.build_bundle("VIT16", seed=4)
    path = JC.save_params(jb.params, str(tmp_path / "vit.npz"))
    jpg = write_jpeg(tmp_path / "in.jpg", w=300, h=400)
    got = vit_example.main(["--image", jpg, "--params", path, "--device",
                            "cpu"])
    trans, x = jax_load(jpg, 32, VIT_MEAN, VIT_STD)
    hold_maps(got, jax_vit(jb, x[0], trans, False, MDA_PATCHES))


# --- the CLIP walkthrough ---

def test_clip_run_matches_xai_tpu(tmp_path):
    jb, tb = clip_twins(str(tmp_path / "clip.npz"))
    x = np.random.RandomState(4).randn(32, 32, 3).astype(np.float32)
    te = np.array(jb.extras["text_embeddings"])
    got = clip_example.run(tb, torch.from_numpy(x),
                           torch.from_numpy(te[:1]), torch.from_numpy(TOKS[:1]))
    hold_maps(got, jax_clip(jb, x, te[:1], TOKS[:1]))


@pytest.fixture()
def clip16_tiny(monkeypatch):
    """The driver-sized tiny CLIP (vocabulary 49,408, context 77) in both
    packages' CLIP16 constructor, with its 1000-prompt table."""
    for configs, cls in ((jclip.CONFIGS, jclip.CLIPConfig),
                         (tclip.CONFIGS, tclip.CLIPConfig)):
        monkeypatch.setitem(configs, "clip_vit_b16", cls(**CLIP_DRIVER))


def test_clip_main_stand_in_caption(clip16_tiny, tmp_path):
    """No --bpe: the class table's first row and xai_tpu's stand-in
    tokens."""
    jb = JC.build_bundle("CLIP16", seed=2)
    path = JC.save_params(jb.params, str(tmp_path / "clip16.npz"))
    jpg = write_jpeg(tmp_path / "in.jpg")
    got = clip_example.main(["--image", jpg, "--params", path, "--device",
                             "cpu"])
    _, x = jax_load(jpg, 32, CLIP_MEAN, CLIP_STD)
    hold_maps(got, jax_clip(jb, x[0], jb.extras["text_embeddings"][:1],
                            clip_example.STAND_IN_TOKENS))


def test_clip_caption_with_a_vocabulary(clip16_tiny):
    """--bpe: the caption tokenized with the given vocabulary and encoded
    by the bundle's own text tower, normalized."""
    from xai_tpu_torch.data.tokenizer import DEFAULT_BPE_PATH, \
        SimpleTokenizer

    tb = build_bundle("CLIP16", device="cpu")
    txt, tokens = clip_example.caption(tb, DEFAULT_BPE_PATH,
                                       "a photo of a cat")
    ids = SimpleTokenizer().tokenize(["a photo of a cat"])
    np.testing.assert_array_equal(tokens.numpy(), ids)
    want = tclip.encode_text_table(tb.module, torch.as_tensor(
        ids, dtype=torch.int64))
    torch.testing.assert_close(txt, want)


@pytest.mark.parametrize("example", ["cnn", "vit", "clip"])
def test_main_refuses_a_non_rgb_image(example, tmp_path, vit16_tiny,
                                      clip16_tiny):
    """An ``L`` image: load_and_preprocess returns None, and the run
    ends."""
    main, flags = {"cnn": (cnn_example.main, ["--model", "TINY_R"]),
                   "vit": (vit_example.main, []),
                   "clip": (clip_example.main, [])}[example]
    png = write_jpeg(tmp_path / "grey.png", mode="L")
    with pytest.raises(SystemExit, match="3-channel"):
        main(["--image", png, "--device", "cpu", *flags])
