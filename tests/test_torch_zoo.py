"""The extended model zoo of xai_tpu_torch against xai_tpu's on the CPU.

Each family at small widths (Inception-v3 at its full width and its
smallest input, 75 px) runs in both packages on the same numpy weights,
carried by ``state_dict_from_jax``: logits and every tap within 1e-4 of
the reference's largest magnitude, in float32.  The weights are drawn in
numpy on the shapes of ``jax.eval_shape(model.init)``, with every
LayerNorm, folded-BN, bias, table and layer-scale entry away from its
init, so the carry of each array matters.  The shapes cover what the
port must do as XLA does: "SAME" padding that pads (ConvNeXt's
downsampling of a 9 px grid, PVT's ``sr`` conv of 3 on an 8 px grid),
Swin's shifted windows beside a window that covers its grid, PVT's
spatial reduction in the cls stage, both MaxViT forms.

The 15 zoo names outside the drivers' table are checked at full width
for their keys and shapes, without allocating: ``jax.eval_shape`` on the
JAX side, modules on the meta device on the port's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xai_tpu.models import EXTENDED_ZOO as JAX_ZOO
from xai_tpu.models import convnext as jcn
from xai_tpu.models import inception as jinc
from xai_tpu.models import maxvit as jmv
from xai_tpu.models import pvt as jpvt
from xai_tpu.models import swin as jsw
from xai_tpu.models import vgg as jvgg
from xai_tpu.models import vit as jvit
from xai_tpu.runners.common import MODEL_TABLE

from xai_tpu_torch.convert.from_jax import jax_leaf_name, state_dict_from_jax
from xai_tpu_torch.models import EXTENDED_ZOO, get_bundle
from xai_tpu_torch.models import convnext, inception, maxvit, pvt, swin, vgg
from xai_tpu_torch.models import vit
from xai_tpu_torch.models.common import Conv2dSame, same_pads

from torch_one_thread import one_torch_thread  # noqa: F401 (autouse)

REL = 1e-4

VGG_CFG = (8, "M", 16, "M", 32, 32, "M", 64, 64, "M", 64, 64, "M")

# name -> (flax module, port module, input px)
SMALL = {
    "vgg": (lambda: jvgg.VGG(VGG_CFG, 10, 32),
            lambda: vgg.VGG(VGG_CFG, 10, 32, img_hw=32), 32),
    "inception": (jinc.InceptionV3, inception.InceptionV3, 75),
    "convnext": (
        lambda: jcn.ConvNeXt(depths=(1, 2), dims=(8, 16), num_classes=10),
        lambda: convnext.ConvNeXt((1, 2), (8, 16), 10), 36),
    "swin": (
        lambda: jsw.SwinTransformer(depths=(2, 2, 2), num_heads=(2, 2, 4),
                                    embed_dim=8, window=4, num_classes=10),
        lambda: swin.SwinTransformer((2, 2, 2), (2, 2, 4), 8, 4, 10,
                                     img_hw=64), 64),
    "pvt": (
        lambda: jpvt.PVT(depths=(1, 1, 2), dims=(8, 16, 24),
                         num_heads=(1, 2, 2), mlp_ratios=(2, 2, 2),
                         sr_ratios=(3, 2, 2), patch_sizes=(4, 2, 2),
                         num_classes=10, img_hw=32),
        lambda: pvt.PVT((1, 1, 2), (8, 16, 24), (1, 2, 2), (2, 2, 2),
                        (3, 2, 2), (4, 2, 2), 10, img_hw=32), 32),
    "maxvit_tv": (
        lambda: jmv.MaxViTTV(depths=(1, 1), dims=(16, 32), stem_dim=16,
                             window=4, head_dim=8, num_classes=10),
        lambda: maxvit.MaxViTTV((1, 1), (16, 32), 16, 4, 8, 10, img_hw=64),
        64),
    "maxvit_paper": (
        lambda: jmv.MaxViT(depths=(2, 1), dims=(16, 32), stem_dim=16,
                           window=4, num_classes=10),
        lambda: maxvit.MaxViT((2, 1), (16, 32), 16, 4, 10, img_hw=64), 64),
}

TAPS = {
    "vgg": ["pool1", "pool3", "pool5", "features"],
    "inception": ["mixed_6e", "layer4"],
    "convnext": ["stage0", "stage1", "layer4"],
    "swin": ["stage0", "stage1", "stage2", "layer4"],
    "pvt": ["stage0", "stage1", "layer4"],
    "maxvit_tv": ["stage0", "stage1", "layer4"],
    "maxvit_paper": ["stage0", "stage1", "layer4"],
}


def flat(tree) -> dict:
    """xai_tpu's ``save_params`` key rule, in memory."""
    return {"/".join(str(getattr(p, "key", p)) for p in kp): np.asarray(v)
            for kp, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def param_shapes(jm, hw: int):
    return jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, hw, hw, 3))))["params"]


def numpy_params(jm, hw: int, seed: int = 0):
    """Seeded numpy weights on the flax module's shapes: kernels
    N(0, 1/fan_in), LayerNorm and folded-BN scales 1 + N(0, 0.2^2),
    layer scales U(0.5, 1.5), every other array N(0, 0.05^2)."""
    rs = np.random.RandomState(seed)

    def draw(kp, s):
        leaf = str(getattr(kp[-1], "key", kp[-1]))
        if leaf == "kernel":
            w = rs.randn(*s.shape) / np.sqrt(np.prod(s.shape[:-1]))
        elif leaf == "scale":
            w = 1.0 + 0.2 * rs.randn(*s.shape)
        elif leaf == "gamma":
            w = rs.uniform(0.5, 1.5, s.shape)
        else:
            w = 0.05 * rs.randn(*s.shape)
        return w.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, param_shapes(jm, hw))


def nhwc(t: torch.Tensor) -> np.ndarray:
    t = t.detach().numpy()
    return t.transpose(0, 2, 3, 1) if t.ndim == 4 else t


def close(got, ref, rel=REL):
    ref = np.asarray(ref)
    scale = float(np.max(np.abs(ref)))
    assert scale > 0
    err = float(np.max(np.abs(np.asarray(got) - ref)))
    assert err <= rel * scale, (err, scale)


@pytest.fixture(scope="module")
def twins():
    """name -> (reference logits, reference taps, port logits, port
    taps), computed once a family."""
    cache = {}

    def get(name):
        if name not in cache:
            make_jax, make_port, hw = SMALL[name]
            jm = make_jax()
            params = numpy_params(jm, hw)
            x = np.random.RandomState(1).randn(2, hw, hw, 3).astype(
                np.float32)
            ref, rtaps = jax.jit(lambda p, xb: jm.apply(
                {"params": p}, xb, taps=True))(params, jnp.asarray(x))
            tm = make_port()
            tm.load_state_dict(state_dict_from_jax(flat(params)))
            with torch.no_grad():
                got, gtaps = tm.eval()(
                    torch.from_numpy(x.transpose(0, 3, 1, 2).copy()),
                    taps=True)
            cache[name] = (np.asarray(ref), rtaps, got, gtaps)
        return cache[name]

    return get


@pytest.mark.parametrize("name", list(SMALL))
def test_logits_match_xai_tpu(twins, name):
    ref, _, got, _ = twins(name)
    assert got.shape == ref.shape
    close(got.numpy(), ref)


@pytest.mark.parametrize("name,tap", [(n, t) for n in SMALL
                                      for t in TAPS[n]])
def test_taps_match_xai_tpu(twins, name, tap):
    _, rtaps, _, gtaps = twins(name)
    assert sorted(gtaps) == sorted(rtaps)
    close(nhwc(gtaps[tap]), rtaps[tap])


def test_swin_case_shifts_and_covers():
    """The Swin case has shifted blocks, a window the grid does not cover,
    and a last stage whose window covers its grid (shift dropped)."""
    m = SMALL["swin"][1]()
    shifts = [(getattr(m, f"stage{s}_block1").shift,
               getattr(m, f"stage{s}_block1").ws) for s in range(3)]
    assert shifts == [(2, 4), (2, 4), (0, 4)]


@pytest.mark.parametrize("size,kernel,stride,want", [
    (9, 2, 2, (0, 1)), (8, 3, 3, (0, 1)), (30, 4, 4, (1, 1)),
    (224, 4, 4, (0, 0)), (7, 1, 1, (0, 0)), (5, 3, 1, (1, 1))])
def test_same_pads_are_xlas(size, kernel, stride, want):
    assert same_pads(size, kernel, stride) == want
    x = np.random.RandomState(0).randn(1, size, size, 2).astype(np.float32)
    w = np.random.RandomState(1).randn(kernel, kernel, 2, 3).astype(
        np.float32)
    ref = jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(w), (stride, stride), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"))
    conv = Conv2dSame(2, 3, kernel, stride=stride, bias=False)
    conv.weight.data = torch.from_numpy(w.transpose(3, 2, 0, 1).copy())
    got = conv(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()))
    close(nhwc(got), ref, 1e-6)


# --- the 15 full-width names ---

FULL = sorted(set(JAX_ZOO) - set(MODEL_TABLE))


def jax_module(name):
    family, arch = JAX_ZOO[name]
    return {
        "vgg": lambda: jvgg.make_model(arch),
        "vit": lambda: jvit.make_model(jvit.CLI_ARCH.get(arch, arch)),
        "convnext": lambda: jcn.ConvNeXt(num_classes=1000,
                                         **jcn.ARCHS[arch]),
        "maxvit": jmv.MaxViTTV,
        "inception": jinc.InceptionV3,
        "swin": lambda: jsw.SwinTransformer(num_classes=1000,
                                            **jsw.ARCHS[arch]),
        "pvt": lambda: jpvt.PVT(num_classes=1000, **jpvt.ARCHS[arch]),
    }[family]()


def port_module(name):
    family, arch = EXTENDED_ZOO[name]
    return {
        "vgg": lambda: vgg.make_model(arch),
        "vit": lambda: vit.make_model(vit.CLI_ARCH.get(arch, arch)),
        "convnext": lambda: convnext.ConvNeXt(**convnext.ARCHS[arch]),
        "maxvit": maxvit.MaxViTTV,
        "inception": inception.InceptionV3,
        "swin": lambda: swin.SwinTransformer(**swin.ARCHS[arch]),
        "pvt": lambda: pvt.PVT(**pvt.ARCHS[arch]),
    }[family]()


@pytest.mark.parametrize("name", FULL)
def test_full_width_keys_and_shapes(name):
    """Every port parameter is a JAX leaf of the transposed shape, and
    every JAX leaf is a port parameter: the weight carry of a full-width
    checkpoint loads with nothing missing and nothing left over."""
    hw = 299 if name == "IV3" else 224
    want = {"/".join(str(getattr(p, "key", p)) for p in kp): s.shape
            for kp, s in jax.tree_util.tree_flatten_with_path(
                param_shapes(jax_module(name), hw))[0]}
    with torch.device("meta"):
        module = port_module(name)
    got = {}
    for key, value in module.state_dict().items():
        shape = tuple(value.shape)
        if key.endswith("weight"):
            shape = (shape[2:] + shape[1::-1] if len(shape) == 4
                     else shape[::-1])
        got[jax_leaf_name(key)] = shape
    assert got == want


@pytest.fixture(scope="module")
def pvt_tiny_state():
    return get_bundle("pvt_tiny", seed=1).module.state_dict()


def _missing(state):
    del state["stage1_block0.attn.q.weight"]


def _extra(state):
    state["extra_norm.scale"] = torch.ones(3)


def _misshapen(state):
    state["head.weight"] = torch.zeros(3, 512)


@pytest.mark.parametrize("spoil,named", [
    (_missing, "Missing key.*stage1_block0.attn.q.weight"),
    (_extra, "Unexpected key.*extra_norm.scale"),
    (_misshapen, "size mismatch for head.weight"),
])
def test_check_state_dict_names_the_key(pvt_tiny_state, spoil, named):
    """A zoo builder loads its state strictly: a state dict that misses a
    key, has an extra one or gives one another shape is refused, naming
    the key; the whole one loads bit for bit."""
    state = dict(pvt_tiny_state)
    spoil(state)
    with pytest.raises(RuntimeError, match=named):
        get_bundle("pvt_tiny", state)
    whole = get_bundle("pvt_tiny", dict(pvt_tiny_state)).module.state_dict()
    for key, value in pvt_tiny_state.items():
        assert torch.equal(whole[key], value), key


def test_init_follows_flaxs_scheme():
    """Seeded random weights: LeCun-normal kernels (std 1/sqrt(fan_in)),
    zero biases, N(0, 0.02) tables and positional embeddings, a zero cls
    token, unit LayerNorm and folded-BN scales, layer scale 1e-6; the
    same seed gives the same weights."""
    from xai_tpu_torch.models.common import init_flax_default
    m = init_flax_default(SMALL["pvt"][1](), seed=3)
    again = init_flax_default(SMALL["pvt"][1](), seed=3)
    for (k, v), (k2, v2) in zip(m.state_dict().items(),
                                again.state_dict().items()):
        assert k == k2 and torch.equal(v, v2), k
    sd = m.state_dict()
    w = sd["stage0_block0.mlp_fc1.weight"]
    assert abs(float(w.std()) * np.sqrt(w.shape[1]) - 1.0) < 0.2
    assert float(w.abs().max()) <= 2.0 / np.sqrt(w.shape[1]) / 0.8796 + 1e-6
    assert not sd["stage0_block0.mlp_fc1.bias"].any()
    assert abs(float(sd["pos_embed0"].std()) - 0.02) < 0.005
    assert not sd["cls_token"].any()
    assert torch.equal(sd["norm.scale"], torch.ones(24))
    cn = init_flax_default(SMALL["convnext"][1](), seed=0).state_dict()
    assert torch.equal(cn["stage0_block0.gamma"], torch.full((8,), 1e-6))
    mv = init_flax_default(SMALL["maxvit_tv"][1](), seed=0).state_dict()
    assert torch.equal(mv["stage0_block0.mbconv.bn_a.scale"],
                       torch.ones(64))
    assert abs(float(mv["stage0_block0.window_attn.attn.rel_bias_table"]
                     .std()) - 0.02) < 0.01
