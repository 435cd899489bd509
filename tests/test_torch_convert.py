"""The port's checkpoint converters against xai_tpu's on the CPU.

Every converter of ``xai_tpu/convert/cli.py ARCH_CONVERTERS`` has a copy
in ``xai_tpu_torch/convert/torch_import.py``; on seeded state dicts in the
source layouts both must give the same tree, array for array and bit for
bit.  The layouts with a torch oracle in the JAX suite's tests
(torchvision ResNet, VGG, timm and torchvision ViT, ConvNeXt, Swin and
MaxViT) also hold the oracle's logits against the port's model on the
converted weights.  The HuggingFace Swin and PVT, openai and HuggingFace
CLIP and torchvision Inception-v3 layouts have no oracle here: their
seeded arrays stand under exactly the keys that xai_tpu's converter reads
(a recording mapping checks it), and the converted weights load into the
port's model with nothing missing or left over; Swin and PVT's logits are
held against xai_tpu's flax models.

The CLI writes the ``.npz`` that xai_tpu's converter followed by its
``save_params`` writes, which both packages' ``load_params`` read.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn as nn

from xai_tpu.convert import torch_import as JI
from xai_tpu.models import convnext as jcn
from xai_tpu.models import inception as jinc
from xai_tpu.models import pvt as jpvt
from xai_tpu.models import swin as jsw
from xai_tpu.runners.common import load_params as jax_load_params
from xai_tpu.runners.common import save_params

from xai_tpu_torch.convert import cli
from xai_tpu_torch.convert import torch_import as TI
from xai_tpu_torch.convert.from_jax import load_params, state_dict_from_jax
from xai_tpu_torch.models import clip, convnext, inception, maxvit, pvt
from xai_tpu_torch.models import resnet, swin, vgg, vit

from test_convnext import TorchCNBlock, TorchConvNeXt, _LN2d
from test_maxvit_convert import TVMaxVit
from test_swin_convert import OracleSwin
from test_torchvision_vit import _to_torchvision_keys
from torch_oracles import TorchResNet, TorchVGG, TorchViT
from torch_one_thread import one_torch_thread  # noqa: F401 (autouse)


def leaves(tree, pre=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from leaves(v, f"{pre}{k}/")
        else:
            yield f"{pre}{k}", v


def assert_bit_equal(got, want):
    got, want = dict(leaves(got)), dict(leaves(want))
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        w = w.detach().numpy() if hasattr(w, "detach") else np.asarray(w)
        g = np.asarray(got[k])
        assert g.dtype == w.dtype and g.shape == w.shape, k
        assert np.array_equal(np.ascontiguousarray(g).view(np.uint8),
                              np.ascontiguousarray(w).view(np.uint8)), k


class Recording(dict):
    """A state dict that notes every key a converter reads."""

    def __init__(self, *a, **k):
        super().__init__(*a, **k)
        self.read = set()

    def __getitem__(self, key):
        self.read.add(key)
        return super().__getitem__(key)


def randomize_bn(model, seed=0):
    gen = torch.Generator().manual_seed(seed)
    for m in model.modules():
        if isinstance(m, nn.BatchNorm2d):
            m.running_mean.copy_(0.1 * torch.randn(m.num_features,
                                                   generator=gen))
            m.running_var.copy_(0.6 + torch.rand(m.num_features,
                                                 generator=gen))
            m.weight.data.copy_(1 + 0.2 * torch.randn(m.num_features,
                                                      generator=gen))
            m.bias.data.copy_(0.1 * torch.randn(m.num_features,
                                                generator=gen))
    return model


def close(got, ref, rel=1e-4):
    ref = np.asarray(ref)
    scale = float(np.max(np.abs(ref)))
    err = float(np.max(np.abs(np.asarray(got) - ref)))
    assert err <= rel * scale, (err, scale)


def port_logits(module, tree, x):
    module.load_state_dict(state_dict_from_jax(TI.flatten(tree)))
    with torch.no_grad():
        return module.eval()(torch.from_numpy(x)).numpy()


# --- the layouts with a torch oracle ---

def _vit_cfg():
    return vit.ViTConfig(patch=8, embed_dim=64, depth=2, num_heads=4,
                         num_classes=11, img_hw=32)


ORACLES = {
    # name -> (oracle, converter and kwargs, the port's module, px)
    "resnet": (lambda: randomize_bn(TorchResNet((1, 1, 1, 1))),
               ("resnet_from_torch", dict(layers=(1, 1, 1, 1))),
               lambda: resnet.ResNet(layers=(1, 1, 1, 1)), 64),
    "vgg": (lambda: TorchVGG(), ("vgg_from_torch", {}),
            lambda: vgg.VGG((8, "M", 16, "M"), 10, 32, img_hw=32), 32),
    "vit_timm": (lambda: TorchViT(patch=8, dim=64, depth=2, heads=4,
                                  img=32, num_classes=11),
                 ("vit_from_torch", dict(depth=2)),
                 lambda: vit.VisionTransformer(_vit_cfg()), 32),
    "vit_torchvision": (lambda: TorchViT(patch=8, dim=64, depth=2, heads=4,
                                         img=32, num_classes=11),
                        ("vit_from_torchvision", dict(depth=2)),
                        lambda: vit.VisionTransformer(_vit_cfg()), 32),
    "convnext": (lambda: TorchConvNeXt((1, 1), (8, 16), 5),
                 ("convnext_from_torch", dict(depths=(1, 1))),
                 lambda: convnext.ConvNeXt((1, 1), (8, 16), 5), 32),
    "swin_torchvision": (lambda: OracleSwin((1, 2), (2, 4), dim=8, ws=4,
                                            num_classes=5),
                         ("swin_from_torch", dict(depths=(1, 2))),
                         lambda: swin.SwinTransformer((1, 2), (2, 4), 8, 4, 5,
                                                      img_hw=32), 32),
    "maxvit": (lambda: randomize_bn(TVMaxVit()),
               ("maxvit_from_torch", dict(depths=(1, 1))),
               lambda: maxvit.MaxViTTV((1, 1), (16, 32), 16, 4, 8, 10,
                                       img_hw=64), 64),
}


@pytest.fixture(scope="module")
def oracle_runs():
    cache = {}

    def get(name):
        if name not in cache:
            make_oracle, (fn, kw), make_port, hw = ORACLES[name]
            torch.manual_seed(0)
            oracle = make_oracle().eval()
            for m in oracle.modules():
                if isinstance(m, TorchCNBlock):   # away from 1e-6
                    m.layer_scale.data.uniform_(0.5, 1.5)
                if isinstance(m, _LN2d):
                    # torchvision's LayerNorm2d has eps 1e-6, as xai_tpu;
                    # the oracle's class keeps nn.LayerNorm's 1e-5, which
                    # moves its logits by 1.5e-4 of their largest
                    m.eps = 1e-6
            sd = oracle.state_dict()
            if name == "vit_torchvision":
                sd = _to_torchvision_keys(sd, 2)
            x = np.random.RandomState(1).randn(2, 3, hw, hw).astype(
                np.float32)
            with torch.no_grad():
                want = oracle(torch.from_numpy(x)).numpy()
            src = getattr(JI, fn, None) or {
                "convnext_from_torch": jcn.convnext_from_torch,
                "swin_from_torch": jsw.swin_from_torch}[fn]
            cache[name] = (getattr(TI, fn)(sd, **kw), src(sd, **kw),
                           want, make_port, x)
        return cache[name]

    return get


@pytest.mark.parametrize("name", list(ORACLES))
def test_converter_is_bit_equal_to_xai_tpus(oracle_runs, name):
    got, ref, *_ = oracle_runs(name)
    assert_bit_equal(got, ref)


@pytest.mark.parametrize("name", list(ORACLES))
def test_oracle_logits_on_the_port(oracle_runs, name):
    got, _, want, make_port, x = oracle_runs(name)
    close(port_logits(make_port(), got, x), want)


# --- the layouts without an oracle: seeded arrays under the keys read ---

def _rand(rs, *shape):
    return torch.from_numpy((0.1 * rs.randn(*shape)).astype(np.float32))


def _lin(sd, rs, name, cin, cout, bias=True):
    sd[f"{name}.weight"] = _rand(rs, cout, cin)
    if bias:
        sd[f"{name}.bias"] = _rand(rs, cout)


def _ln(sd, rs, name, dim):
    sd[f"{name}.weight"] = 1 + _rand(rs, dim)
    sd[f"{name}.bias"] = _rand(rs, dim)


SWIN_HF = dict(depths=(1, 2), heads=(2, 4), dim=8, ws=4, classes=5)


def swin_hf_state(seed=0, depths=(1, 2), heads=(2, 4), dim=8, ws=4,
                  classes=5):
    """HuggingFace SwinForImageClassification's keys and shapes."""
    rs = np.random.RandomState(seed)
    sd = {"swin.embeddings.patch_embeddings.projection.weight":
          _rand(rs, dim, 3, 4, 4),
          "swin.embeddings.patch_embeddings.projection.bias": _rand(rs, dim)}
    _ln(sd, rs, "swin.embeddings.norm", dim)
    d = dim
    for s, depth in enumerate(depths):
        if s > 0:
            t = f"swin.encoder.layers.{s - 1}.downsample"
            _ln(sd, rs, f"{t}.norm", 4 * d)
            _lin(sd, rs, f"{t}.reduction", 4 * d, 2 * d, bias=False)
            d *= 2
        for b in range(depth):
            t = f"swin.encoder.layers.{s}.blocks.{b}"
            _ln(sd, rs, f"{t}.layernorm_before", d)
            _ln(sd, rs, f"{t}.layernorm_after", d)
            for part in ("query", "key", "value"):
                _lin(sd, rs, f"{t}.attention.self.{part}", d, d)
            sd[f"{t}.attention.self.relative_position_bias_table"] = _rand(
                rs, (2 * ws - 1) ** 2, heads[s])
            # a buffer the converter does not read
            sd[f"{t}.attention.self.relative_position_index"] = \
                torch.zeros(ws * ws * ws * ws, dtype=torch.int64)
            _lin(sd, rs, f"{t}.attention.output.dense", d, d)
            _lin(sd, rs, f"{t}.intermediate.dense", d, 4 * d)
            _lin(sd, rs, f"{t}.output.dense", 4 * d, d)
    _ln(sd, rs, "swin.layernorm", d)
    _lin(sd, rs, "classifier", d, classes)
    return sd


PVT_HF = dict(depths=(1, 1), dims=(8, 16), heads=(1, 2), mlp=(2, 2),
              sr=(4, 2), patches=(4, 2), img=32, classes=5)


def pvt_hf_state(seed=0, depths=(1, 1), dims=(8, 16), heads=(1, 2),
                 mlp=(2, 2), sr=(4, 2), patches=(4, 2), img=32, classes=5):
    """HuggingFace PvtForImageClassification's keys and shapes (sr > 1 in
    the cls stage too, which the JAX and port models take)."""
    rs = np.random.RandomState(seed)
    sd, cin, grid = {}, 3, img
    for s, depth in enumerate(depths):
        pe = f"pvt.encoder.patch_embeddings.{s}"
        grid //= patches[s]
        d = dims[s]
        sd[f"{pe}.projection.weight"] = _rand(rs, d, cin, patches[s],
                                              patches[s])
        sd[f"{pe}.projection.bias"] = _rand(rs, d)
        _ln(sd, rs, f"{pe}.layer_norm", d)
        last = s == len(depths) - 1
        sd[f"{pe}.position_embeddings"] = _rand(rs, 1, grid * grid + last, d)
        if last:
            sd[f"{pe}.cls_token"] = _rand(rs, 1, 1, d)
        for b in range(depth):
            t = f"pvt.encoder.block.{s}.{b}"
            _ln(sd, rs, f"{t}.layer_norm_1", d)
            _ln(sd, rs, f"{t}.layer_norm_2", d)
            for part in ("query", "key", "value"):
                _lin(sd, rs, f"{t}.attention.self.{part}", d, d)
            _lin(sd, rs, f"{t}.attention.output.dense", d, d)
            _lin(sd, rs, f"{t}.mlp.dense1", d, d * mlp[s])
            _lin(sd, rs, f"{t}.mlp.dense2", d * mlp[s], d)
            if sr[s] > 1:
                sd[f"{t}.attention.self.sequence_reduction.weight"] = \
                    _rand(rs, d, d, sr[s], sr[s])
                sd[f"{t}.attention.self.sequence_reduction.bias"] = \
                    _rand(rs, d)
                _ln(sd, rs, f"{t}.attention.self.layer_norm", d)
        cin = d
    _ln(sd, rs, "pvt.encoder.layer_norm", dims[-1])
    _lin(sd, rs, "classifier", dims[-1], classes)
    return sd


CLIP_TINY = clip.CLIPConfig(patch=8, vision_width=32, vision_layers=2,
                            vision_heads=2, embed_dim=16, text_width=32,
                            text_heads=2, text_layers=2, vocab_size=64,
                            context_length=77, img_hw=32)


def _clip_block(sd, rs, t, w):
    _ln(sd, rs, f"{t}.ln_1", w)
    _ln(sd, rs, f"{t}.ln_2", w)
    sd[f"{t}.attn.in_proj_weight"] = _rand(rs, 3 * w, w)
    sd[f"{t}.attn.in_proj_bias"] = _rand(rs, 3 * w)
    _lin(sd, rs, f"{t}.attn.out_proj", w, w)
    _lin(sd, rs, f"{t}.mlp.c_fc", w, 4 * w)
    _lin(sd, rs, f"{t}.mlp.c_proj", 4 * w, w)


def clip_openai_state(seed=0, cfg=CLIP_TINY, dtype=torch.float16):
    """openai CLIP's keys and shapes, stored half as openai stores them."""
    rs = np.random.RandomState(seed)
    w, tw = cfg.vision_width, cfg.text_width
    sd = {"visual.conv1.weight": _rand(rs, w, 3, cfg.patch, cfg.patch),
          "visual.class_embedding": _rand(rs, w),
          "visual.positional_embedding": _rand(rs, cfg.tokens, w),
          "visual.proj": _rand(rs, w, cfg.embed_dim),
          "token_embedding.weight": _rand(rs, cfg.vocab_size, tw),
          "positional_embedding": _rand(rs, cfg.context_length, tw),
          "text_projection": _rand(rs, tw, cfg.embed_dim),
          "logit_scale": torch.tensor(4.6052)}
    _ln(sd, rs, "visual.ln_pre", w)
    _ln(sd, rs, "visual.ln_post", w)
    _ln(sd, rs, "ln_final", tw)
    for i in range(cfg.vision_layers):
        _clip_block(sd, rs, f"visual.transformer.resblocks.{i}", w)
    for i in range(cfg.text_layers):
        _clip_block(sd, rs, f"transformer.resblocks.{i}", tw)
    return {k: v.to(dtype) if v.is_floating_point() else v
            for k, v in sd.items()}


def clip_hf_state(seed=0, cfg=CLIP_TINY):
    """HuggingFace CLIPModel's keys and shapes."""
    rs = np.random.RandomState(seed)
    w, tw = cfg.vision_width, cfg.text_width
    v, t = "vision_model", "text_model"
    sd = {f"{v}.embeddings.patch_embedding.weight":
          _rand(rs, w, 3, cfg.patch, cfg.patch),
          f"{v}.embeddings.class_embedding": _rand(rs, w),
          f"{v}.embeddings.position_embedding.weight":
          _rand(rs, cfg.tokens, w),
          "visual_projection.weight": _rand(rs, cfg.embed_dim, w),
          f"{t}.embeddings.token_embedding.weight":
          _rand(rs, cfg.vocab_size, tw),
          f"{t}.embeddings.position_embedding.weight":
          _rand(rs, cfg.context_length, tw),
          "text_projection.weight": _rand(rs, cfg.embed_dim, tw),
          "logit_scale": torch.tensor(4.6052)}
    _ln(sd, rs, f"{v}.pre_layrnorm", w)
    _ln(sd, rs, f"{v}.post_layernorm", w)
    _ln(sd, rs, f"{t}.final_layer_norm", tw)
    for tower, width, n in ((v, w, cfg.vision_layers),
                            (t, tw, cfg.text_layers)):
        for i in range(n):
            s = f"{tower}.encoder.layers.{i}"
            for part in ("q_proj", "k_proj", "v_proj", "out_proj"):
                _lin(sd, rs, f"{s}.self_attn.{part}", width, width)
            _ln(sd, rs, f"{s}.layer_norm1", width)
            _ln(sd, rs, f"{s}.layer_norm2", width)
            _lin(sd, rs, f"{s}.mlp.fc1", width, 4 * width)
            _lin(sd, rs, f"{s}.mlp.fc2", 4 * width, width)
    return sd


def inception_tv_state(seed=0):
    """torchvision inception_v3's keys and shapes (the port's module gives
    each BasicConv2d's conv and bn; every BN with its running stats and
    counter), with an auxiliary head the converter skips."""
    rs = np.random.RandomState(seed)
    sd = {}
    for name, m in inception.InceptionV3().named_modules():
        if isinstance(m, inception.BasicConv2d):
            sd[f"{name}.conv.weight"] = _rand(rs, *m.conv.weight.shape)
            c = m.conv.out_channels
            sd[f"{name}.bn.weight"] = 1 + _rand(rs, c)
            sd[f"{name}.bn.bias"] = _rand(rs, c)
            sd[f"{name}.bn.running_mean"] = _rand(rs, c)
            sd[f"{name}.bn.running_var"] = torch.from_numpy(
                rs.uniform(0.5, 1.5, c).astype(np.float32))
            sd[f"{name}.bn.num_batches_tracked"] = torch.tensor(0)
    sd["AuxLogits.conv0.conv.weight"] = _rand(rs, 128, 768, 1, 1)
    sd["AuxLogits.conv0.bn.weight"] = _rand(rs, 128)
    sd["AuxLogits.fc.weight"] = _rand(rs, 1000, 768)
    _lin(sd, rs, "fc", 2048, 1000)
    return sd


def _unread(name, sd):
    """The keys of ``sd`` that no converter should read."""
    return {k for k in sd if k.endswith(("num_batches_tracked",
                                         "relative_position_index"))
            or k.startswith("AuxLogits")}


LAYOUTS = {
    # name -> (state dict, converter and kwargs)
    "swin_hf": (lambda: swin_hf_state(),
                ("swin_from_hf", dict(depths=SWIN_HF["depths"]))),
    "pvt_hf": (lambda: pvt_hf_state(),
               ("pvt_from_hf", dict(depths=PVT_HF["depths"]))),
    "clip_openai": (lambda: clip_openai_state(),
                    ("clip_from_torch", dict(vision_layers=2,
                                             text_layers=2))),
    "clip_hf": (lambda: clip_hf_state(),
                ("clip_from_hf", dict(vision_layers=2, text_layers=2))),
    "inception_torchvision": (lambda: inception_tv_state(),
                              ("inception_from_torch", {})),
}


def xai_tpu_converter(fn):
    return getattr(JI, fn, None) or {
        "swin_from_hf": jsw.swin_from_hf, "pvt_from_hf": jpvt.pvt_from_hf,
        "inception_from_torch": jinc.inception_from_torch}[fn]


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_layout_converter_is_bit_equal_to_xai_tpus(name):
    make_sd, (fn, kw) = LAYOUTS[name]
    sd = make_sd()
    seen = Recording(sd)
    ref = xai_tpu_converter(fn)(seen, **kw)
    # the seeded arrays are exactly what xai_tpu's converter reads
    assert seen.read == set(sd) - _unread(name, sd)
    got = getattr(TI, fn)(dict(sd), **kw)
    assert_bit_equal(got, ref)


def test_clip_half_checkpoints_become_float32():
    """openai's half-precision arrays come out float32, as xai_tpu's
    converter casts them; the model files' converters keep the dtype."""
    tree = TI.clip_from_torch(clip_openai_state(), 2, 2)
    assert {np.asarray(v).dtype for _, v in leaves(tree)} == {
        np.dtype(np.float32)}
    half = {k: v.half() for k, v in swin_hf_state().items()
            if v.is_floating_point()}
    tree = TI.swin_from_hf(half, (1, 2))
    assert {np.asarray(v).dtype for _, v in leaves(tree)} == {
        np.dtype(np.float16)}
    assert_bit_equal(tree, jsw.swin_from_hf(half, (1, 2)))


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_layout_loads_into_the_port(name):
    """The converted weights cover the port's module exactly."""
    make_sd, (fn, kw) = LAYOUTS[name]
    state = state_dict_from_jax(TI.flatten(getattr(TI, fn)(make_sd(), **kw)))
    module = {
        "swin_hf": lambda: swin.SwinTransformer(
            (1, 2), (2, 4), 8, 4, 5, img_hw=32),
        "pvt_hf": lambda: pvt.PVT((1, 1), (8, 16), (1, 2), (2, 2), (4, 2),
                                  (4, 2), 5, img_hw=32),
        "clip_openai": lambda: clip.CLIP(CLIP_TINY),
        "clip_hf": lambda: clip.CLIP(CLIP_TINY),
        "inception_torchvision": inception.InceptionV3,
    }[name]()
    module.load_state_dict(state)
    for key, value in module.state_dict().items():
        assert torch.equal(value, state[key].to(value.dtype)), key


@pytest.mark.parametrize("name", ["swin_hf", "pvt_hf"])
def test_hf_logits_match_xai_tpus_model(name):
    make_sd, (fn, kw) = LAYOUTS[name]
    sd = make_sd()
    ref_tree = xai_tpu_converter(fn)(sd, **kw)
    if name == "swin_hf":
        jm = jsw.SwinTransformer(depths=(1, 2), num_heads=(2, 4),
                                 embed_dim=8, window=4, num_classes=5)
        tm = swin.SwinTransformer((1, 2), (2, 4), 8, 4, 5, img_hw=32)
    else:
        jm = jpvt.PVT(depths=(1, 1), dims=(8, 16), num_heads=(1, 2),
                      mlp_ratios=(2, 2), sr_ratios=(4, 2),
                      patch_sizes=(4, 2), num_classes=5, img_hw=32)
        tm = pvt.PVT((1, 1), (8, 16), (1, 2), (2, 2), (4, 2), (4, 2), 5,
                     img_hw=32)
    x = np.random.RandomState(2).randn(2, 32, 32, 3).astype(np.float32)
    want = np.asarray(jax.jit(lambda p, xb: jm.apply({"params": p}, xb))(
        ref_tree, jnp.asarray(x)))
    got = port_logits(tm, getattr(TI, fn)(sd, **kw),
                      x.transpose(0, 3, 1, 2).copy())
    close(got, want)


def test_arch_converters_are_xai_tpus():
    from xai_tpu.convert.cli import ARCH_CONVERTERS
    assert cli.ARCH_CONVERTERS == ARCH_CONVERTERS
    for name, _ in ARCH_CONVERTERS.values():
        assert callable(getattr(TI, name))


def test_from_torch_is_flatten_then_carry():
    """``from_torch`` = the converter, ``save_params``'s flat keys, and the
    weight carry; a VGG16-named checkpoint of the oracle's widths."""
    oracle = TorchVGG().eval()
    state = TI.from_torch("VGG16", oracle.state_dict())
    module = vgg.VGG((8, "M", 16, "M"), 10, 32, img_hw=32)
    module.load_state_dict(state)
    x = torch.from_numpy(np.random.RandomState(0).randn(
        1, 3, 32, 32).astype(np.float32))
    with torch.no_grad():
        close(module(x).numpy(), oracle(x).numpy())


# --- the CLI ---

@pytest.mark.parametrize("arch", ["VGG16", "IV3"])
def test_cli_writes_xai_tpus_npz(tmp_path, arch):
    """torch.save a state dict, convert it with the port's CLI: the .npz
    holds the keys and arrays of xai_tpu's converter followed by its
    save_params; both packages' load_params read it, and the port's
    module takes it."""
    if arch == "VGG16":
        sd = TorchVGG().state_dict()
    else:
        sd = inception_tv_state()
    src = tmp_path / "ckpt.pth"
    torch.save(sd, src)
    out = tmp_path / "port.npz"
    cli.main(["--arch", arch, "--torch", str(src), "--out", str(out)])
    fn = {"VGG16": JI.vgg_from_torch,
          "IV3": jinc.inception_from_torch}[arch]
    ref = save_params(fn(sd), str(tmp_path / "xai_tpu.npz"))
    with np.load(out) as a, np.load(ref) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in b.files:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
    jax_tree = jax_load_params(str(out))
    assert_bit_equal(jax_tree, jax.tree.map(np.asarray, fn(sd)))
    module = (vgg.VGG((8, "M", 16, "M"), 10, 32, img_hw=32)
              if arch == "VGG16" else inception.InceptionV3())
    module.load_state_dict(load_params(str(out)))


def test_cli_refuses_a_pickled_module_unless_trusted(tmp_path, capsys):
    src = tmp_path / "module.pth"
    torch.save(TorchVGG(), src)           # a whole module: needs unpickling
    out = tmp_path / "out.npz"
    flags = ["--arch", "VGG16", "--torch", str(src), "--out", str(out)]
    with pytest.raises(SystemExit, match="weights_only=True"):
        cli.main(flags)
    assert not os.path.exists(out)
    cli.main(flags + ["--trust_pickle"])
    assert "unpickling" in capsys.readouterr().out
    with np.load(out) as a:
        assert "conv0/kernel" in a.files and "fc2/bias" in a.files


def test_cli_writes_npz_only(tmp_path):
    with pytest.raises(SystemExit, match="npz"):
        cli.main(["--arch", "VGG16", "--torch", "x.pth", "--out",
                  str(tmp_path / "x.pkl")])
