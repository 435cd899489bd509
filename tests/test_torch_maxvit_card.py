"""MaxViT's dense NHWC layout where it meets PyTorch's kernels: the
shortcut's average pool and the 1x1 convolutions run as GEMMs.

On the CPU: each against the convolution it stands for.  The tests marked
``card`` hold a small MaxViT's input gradient on the card against the
CPU's (on CUDA, PyTorch's channels-last ``avg_pool2d`` backward gives a
wrong input gradient for torchvision's padded pool, which the shortcut
avoids) and skip without a card; on a machine with one, run them without
this directory's JAX conftest:

    python -m pytest tests/test_torch_maxvit_card.py --noconftest -m card -q
"""
import copy
import json
from pathlib import Path

import pytest
import torch
import torch.nn as nn
import torch.nn.functional as F

from xai_tpu_torch.models import maxvit
from xai_tpu_torch.models.common import conv_nhwc, init_flax_default

from torch_one_thread import one_torch_thread  # noqa: F401 (autouse)

CFG = json.loads((Path(__file__).resolve().parent.parent / "portbench" /
                  "tests" / "configs" / "tiny_maxvit.json").read_text())
# (form, the pool's arguments) as the two MBConv forms call it
POOLS = {"tv": ((3, 2, 1), {"count_include_pad": True}),
         "paper": ((2, 2), {})}


@pytest.fixture
def card():
    """The first CUDA card, or a skip."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def small_maxvit(form):
    """The small MaxViT of ``tiny_maxvit.json`` in torchvision's form or
    the paper's, on seeded weights."""
    args = (tuple(CFG["depths"]), tuple(CFG["dims"]), CFG["stem_dim"],
            CFG["partition"])
    if form == "tv":
        module = maxvit.MaxViTTV(*args, CFG["head_dim"], CFG["num_classes"],
                                 img_hw=CFG["img_hw"])
    else:
        module = maxvit.MaxViT(*args, CFG["num_classes"],
                               img_hw=CFG["img_hw"])
    return init_flax_default(module, 3)


def _rel(a, b):
    return ((a.double() - b.double()).abs().max() /
            b.double().abs().max()).item()


def _randn(shape, seed):
    gen = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=gen)


@pytest.mark.parametrize("form", sorted(POOLS))
def test_pooled_shortcut_is_dense_and_equal(form):
    """The pool through NCHW memory, then the 1x1 convolution, equals both
    on the channels-last view, and comes back dense."""
    pool, kw = POOLS[form]
    conv = nn.Conv2d(16, 32, 1)
    x = _randn((2, 16, 16, 16), 0)
    got = maxvit._pooled_shortcut(conv, x, *pool, **kw)
    want = conv_nhwc(conv, F.avg_pool2d(x.permute(0, 3, 1, 2), *pool, **kw)
                     .permute(0, 2, 3, 1))
    assert got.is_contiguous() and got.shape == (2, 8, 8, 32)
    assert _rel(got, want) < 1e-6


@pytest.mark.parametrize("bias", [True, False])
def test_pointwise_is_the_1x1_convolution(bias):
    conv = nn.Conv2d(16, 64, 1, bias=bias)
    x = _randn((2, 8, 8, 16), 1)
    got = maxvit._pointwise(conv, x)
    assert got.is_contiguous()
    assert _rel(got, conv_nhwc(conv, x)) < 1e-6


# --- on the card ----------------------------------------------------------

@pytest.mark.card
@pytest.mark.parametrize("form", ["tv", "paper"])
def test_input_gradient_on_card_matches_cpu(card, form):
    """The small MaxViT's logits and input gradient (IG's) on the card
    within 1e-5 and 1e-4 of the CPU's, TF32 off (float32 rounding)."""
    module = small_maxvit(form)
    x = _randn((3, 3, 32, 32), 2)

    def run(mod, x):
        x = x.clone().requires_grad_(True)
        logits = mod(x)
        (g,) = torch.autograd.grad(logits[:, 3].sum(), x)
        return logits.detach().cpu(), g.cpu()

    want = run(module, x)
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        got = run(copy.deepcopy(module).to(card), x.to(card))
    assert _rel(got[0], want[0]) < 1e-5
    assert _rel(got[1], want[1]) < 1e-4
