"""ConvNeXt's modules in the port's layout on the card against the CPU.

The model's activations are dense ``[B, H, W, C]`` memory from the stem
on (``models/convnext.py``): cuDNN's depthwise and strided convolutions
read and write channels-last, each linear is one GEMM over the pixels,
and each LayerNorm gets a contiguous input.  On the CPU: that the
modules get such memory.  The tests marked ``card`` hold each module's
output and input gradient on the card against the CPU's, on dense
memory, which the model gives, and on ``[B, H, W, C]`` views of NCHW
memory, at the small model's widths and at convnext_base's, and skip
without a card; on a machine with one, run them without this directory's
JAX conftest:

    python -m pytest tests/test_torch_convnext_card.py --noconftest -m card -q
"""
import copy
import json
from pathlib import Path

import pytest
import torch

from portbench.reference import convnext as ref_convnext
from portbench.weights import make_weights
from xai_tpu_torch.models import convnext
from xai_tpu_torch.models.common import LayerNorm, conv_nhwc

from torch_one_thread import one_torch_thread  # noqa: F401 (autouse)

CFG = json.loads((Path(__file__).resolve().parent.parent / "portbench" /
                  "tests" / "configs" / "tiny_convnext.json").read_text())
CPU = torch.device("cpu")
# (width, side) of one block: the small model's two stages, then
# convnext_base's four at 224 px
BLOCKS = [(16, 8), (32, 4), (128, 56), (256, 28), (512, 14), (1024, 7)]


@pytest.fixture
def card():
    """The first CUDA card, or a skip."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def small_convnext():
    """The small ConvNeXt of ``tiny_convnext.json`` on the benchmark's
    seeded weights (biases drawn, layer scale ``branch_scale``)."""
    module = convnext.ConvNeXt(CFG["depths"], CFG["dims"],
                               CFG["num_classes"])
    module.load_state_dict(make_weights(ref_convnext.param_spec(CFG),
                                        CFG["init"], 3, CPU))
    return module


def block(dim):
    """A ``CNBlock`` of width ``dim`` on the benchmark's seeded weights."""
    cfg = dict(CFG, depths=[1], dims=[dim])
    pre = "stage0_block0."
    w = {k[len(pre):]: v for k, v in make_weights(
        ref_convnext.param_spec(cfg), cfg["init"], 5, CPU).items()
        if k.startswith(pre)}
    module = convnext.CNBlock(dim)
    module.load_state_dict(w)
    return module


# the layouts of a ``[B, H, W, C]`` input: dense memory, as the model's
# modules get it, and a view of NCHW memory
LAYOUTS = ("dense", "nchw_view")


def _nhwc(shape, seed, layout):
    """A seeded random ``[B, H, W, C]`` batch in ``layout``."""
    b, h, w, c = shape
    gen = torch.Generator().manual_seed(seed)
    if layout == "dense":
        return torch.randn(shape, generator=gen)
    return torch.randn((b, c, h, w), generator=gen).permute(0, 2, 3, 1)


def _rel(a, b):
    return ((a.double() - b.double()).abs().max() /
            b.double().abs().max()).item()


def test_blocks_get_dense_memory():
    """Every block and LayerNorm of the small model, the head norm's
    pooled rows included, and every ``pw1`` gets a contiguous input, with
    and without a recorded graph."""
    module = small_convnext()
    seen = []
    for name, mod in module.named_modules():
        if isinstance(mod, (convnext.CNBlock, LayerNorm)) or \
                name.endswith("pw1"):
            mod.register_forward_pre_hook(
                lambda mod, inp, name=name: seen.append(
                    (name, inp[0].dim(), inp[0].is_contiguous())))
    for grad in (False, True):
        seen.clear()
        with torch.set_grad_enabled(grad):
            module(torch.randn(2, 3, 32, 32))
        blocks = [s for s in seen if s[0].startswith("stage")
                  and "." not in s[0]]
        assert [s[0] for s in blocks] == ["stage0_block0",
                                         "stage0_block1", "stage1_block0"]
        norms = {name: dim for name, dim, _ in seen
                 if name.endswith("norm")}
        assert norms.pop("head_norm") == 2 and len(norms) == 3 + 2
        assert set(norms.values()) == {4}
        assert len(seen) == 3 + 3 + 3 + 3
        assert all(dense for _, _, dense in seen)


# --- on the card ----------------------------------------------------------

def _run(fn, x, seed):
    """``fn(x)`` and the input gradient of a seeded random projection of
    it, both on the CPU."""
    x = x.clone().requires_grad_(True)
    y = fn(x)
    gen = torch.Generator().manual_seed(seed)
    proj = torch.randn(y.shape, generator=gen).to(y.device)
    (g,) = torch.autograd.grad((y * proj).sum(), x)
    return y.detach().cpu(), g.cpu()


def _on_card(module, fn, x, card, seed=0):
    """(CPU's, card's) output and input gradient of ``fn(module, x)``,
    TF32 off on the card."""
    want = _run(lambda v: fn(module, v), x, seed)
    card_module = copy.deepcopy(module).to(card)
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        saved = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            got = _run(lambda v: fn(card_module, v), x.to(card), seed)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = saved
    return want, got


@pytest.mark.card
@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("dim,side", BLOCKS)
def test_block_on_card_matches_cpu(card, dim, side, layout):
    """A ``CNBlock`` on either layout: the 7x7 depthwise conv (cuDNN's
    channels-last kernels on dense memory, forward and input gradient),
    the LayerNorm's separate ops (a graph is recorded), the MLP, the layer
    scale and the skip; output within 1e-5 and input gradient within 1e-4
    of the CPU's, relative to their largest values (float32 rounding)."""
    want, got = _on_card(block(dim), lambda m, v: m(v),
                         _nhwc((2, side, side, dim), dim, layout), card)
    assert _rel(got[0], want[0]) < 1e-5
    assert _rel(got[1], want[1]) < 1e-4


STAGES = {
    "stem": (lambda m, v: m.stem_norm(conv_nhwc(m.stem_conv, v)),
             (3, 32, 32, 3)),
    "down1": (lambda m, v: conv_nhwc(m.down1_conv, m.down1_norm(v)),
              (3, 8, 8, 16)),
    "head": (lambda m, v: m.head(m.head_norm(v.mean(dim=(1, 2)))),
             (3, 4, 4, 32)),
    "model": (lambda m, v: m(v.permute(0, 3, 1, 2)), (3, 32, 32, 3)),
}


@pytest.mark.card
@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("part", sorted(STAGES))
def test_parts_on_card_match_cpu(card, part, layout):
    """The stem (the 4x4 stride-4 ``Conv2dSame`` and its norm), a
    downsampling (norm and the 2x2 stride-2 conv), the head (mean pool,
    norm, linear) and the whole small model, each on either layout (the
    model's input: NCHW memory, or a channels-last view); output within
    1e-5 and input gradient within 1e-4 of the CPU's (float32
    rounding)."""
    fn, shape = STAGES[part]
    want, got = _on_card(small_convnext(), fn, _nhwc(shape, 1, layout),
                         card)
    assert _rel(got[0], want[0]) < 1e-5
    assert _rel(got[1], want[1]) < 1e-4
