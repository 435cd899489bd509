"""The ResNet epilogue (``xai_tpu_torch/kernels/bn_act.py``) and the
dispatch of ``models/resnet.py`` that takes it.

On the CPU: the plain version against FoldedBN and ``F.relu`` bit for bit,
the dispatch rule, and the fused code path of the model (the wrapper runs
its plain version on CPU tensors) against the model's plain code.  The
tests marked ``card`` hold the CUDA kernel against the plain version and
skip without a card; on a machine with one, run them without this
directory's JAX conftest:

    python -m pytest tests/test_torch_bn_act.py --noconftest -m card -q
"""
import math

import pytest
import torch
import torch.nn.functional as F

from xai_tpu_torch.kernels import bn_act as kb
from xai_tpu_torch.methods.guided import guided_relu
from xai_tpu_torch.models import resnet
from xai_tpu_torch.models.common import FoldedBN
from xai_tpu_torch.utils import trace

from torch_one_thread import one_torch_thread  # noqa: F401 (autouse)

# (residual, the residual through its own FoldedBN)
FORMS = {"relu": (False, False), "residual": (True, False),
         "residual_bn": (True, True)}
# R101's planes at 224 px (112^2 to 7^2) and a ragged one
PLANES = [(112, 112), (56, 56), (28, 28), (14, 14), (7, 7), (13, 11)]


@pytest.fixture
def card():
    """The first CUDA card, or a skip."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _rows():
    return trace.counters().get("bn_act_rows", 0)


def _special(t, gen, share=0.05):
    """``t`` with about ``share`` of its elements NaN, +-0 or +-inf."""
    flat = t.view(-1)
    picks = torch.rand(flat.shape, generator=gen) < share
    which = torch.randint(0, 5, flat.shape, generator=gen)
    values = torch.tensor([math.nan, 0.0, -0.0, math.inf, -math.inf])
    flat[picks] = values[which[picks]]
    return t


def _operands(shape, form, seed=0, special=True):
    """CPU operands of one epilogue: x, scale, bias[, residual[, its
    scale, its bias]]."""
    gen = torch.Generator().manual_seed(seed)
    n, c, h, w = shape

    def rand(*s):
        t = torch.randn(*s, generator=gen)
        return _special(t, gen) if special else t

    args = [rand(n, c, h, w), rand(c), rand(c)]
    residual, residual_bn = FORMS[form]
    if residual:
        args.append(rand(n, c, h, w))
    if residual_bn:
        args += [rand(c), rand(c)]
    return args


def _bits(t):
    return t.contiguous().view(torch.int32)


def _bits_equal(got, want):
    """Bit for bit: NaN equal to NaN, +0 unequal to -0."""
    return (got.shape == want.shape and got.dtype == want.dtype
            and torch.equal(_bits(got), _bits(want)))


def _randomize_bn(model, seed=0):
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, FoldedBN):
                m.scale.copy_(1 + 0.2 * torch.randn(m.scale.shape,
                                                    generator=gen))
                m.bias.copy_(0.2 * torch.randn(m.bias.shape, generator=gen))
    return model


class _OnCard:
    """A CPU tensor as the dispatch sees a card's: every attribute the
    tensor's but ``is_cuda``."""
    is_cuda = True

    def __init__(self, x):
        self._x = x

    def __getattr__(self, name):
        return getattr(self._x, name)


@pytest.fixture
def on_card(monkeypatch):
    """The dispatch with CPU tensors counted as a card's: the model takes
    its fused code, whose wrapper calls run the plain version on the
    CPU."""
    rule = resnet._fused
    monkeypatch.setattr(resnet, "_fused",
                        lambda x, relu: rule(_OnCard(x), relu))


@pytest.fixture(autouse=True)
def _zero_launches():
    kb.bn_act.launches = 0
    yield


# --- the plain version ----------------------------------------------------

@pytest.mark.parametrize("form", sorted(FORMS))
def test_plain_matches_folded_bn_and_relu(form):
    """Bit for bit the op sequence of models/resnet.py: FoldedBN, the
    residual (through the downsample's FoldedBN), F.relu."""
    args = _operands((2, 6, 7, 9), form)
    x, scale, bias = args[:3]
    bn = FoldedBN(6)
    with torch.no_grad():
        bn.scale.copy_(scale)
        bn.bias.copy_(bias)
        y = bn(x)
        if form != "relu":
            residual = args[3]
            if form == "residual_bn":
                down = FoldedBN(6)
                down.scale.copy_(args[4])
                down.bias.copy_(args[5])
                residual = down(residual)
            y = y + residual
        want = F.relu(y)
    assert _bits_equal(kb.bn_act_plain(*args), want)
    # the special values reach the output and the inputs
    assert bool(torch.isnan(want).any()) and bool(
        (_bits(x) == _bits(torch.tensor(-0.0))).any())


@pytest.mark.parametrize("form", sorted(FORMS))
def test_cpu_call_runs_the_plain_version(form):
    args = _operands((3, 4, 13, 11), form, seed=1)
    assert _bits_equal(kb.bn_act(*args), kb.bn_act_plain(*args))
    assert kb.bn_act.launches == 0


# --- the dispatch ---------------------------------------------------------

class _Stand:
    """What the dispatch reads of a tensor."""

    def __init__(self, is_cuda=True, dtype=torch.float32, contiguous=True):
        self.is_cuda, self.dtype, self._contiguous = (is_cuda, dtype,
                                                      contiguous)

    def is_contiguous(self):
        return self._contiguous


@pytest.mark.parametrize("case,fused", [
    ("card_f32_inference", True), ("card_f32_no_grad", True),
    ("grad_enabled", False), ("cpu", False), ("bf16", False),
    ("not_contiguous", False), ("guided_relu", False),
    ("relu_lambda", False)])
def test_dispatch_rule(case, fused):
    x = _Stand(is_cuda=case != "cpu",
               dtype=torch.bfloat16 if case == "bf16" else torch.float32,
               contiguous=case != "not_contiguous")
    relu = {"guided_relu": guided_relu,
            "relu_lambda": lambda t: F.relu(t)}.get(case, F.relu)
    if case == "grad_enabled":
        with torch.enable_grad():
            assert resnet._fused(x, relu) is fused
    elif case == "card_f32_no_grad":
        with torch.no_grad():
            assert resnet._fused(x, relu) is fused
    else:
        with torch.inference_mode():
            assert resnet._fused(x, relu) is fused


@pytest.mark.parametrize("arch", ["resnet50", "resnext50_32x4d"])
def test_fused_code_matches_plain_code(on_card, arch):
    """The forward through the epilogue's fused branch (which scale meets
    which tensor, the skip, the downsample) against its plain branch, bit
    for bit, with bn_act_rows counting the forward's rows."""
    model = _randomize_bn(resnet.make_model(arch))
    plain = resnet.set_relu(resnet.make_model(arch), lambda t: F.relu(t))
    plain.load_state_dict(model.state_dict())
    x = torch.randn(2, 3, 64, 64, generator=torch.Generator().manual_seed(2))
    with torch.inference_mode():
        before = _rows()
        got, got_taps = model(x, taps=True)
        assert _rows() - before == 2
        want, want_taps = plain(x, taps=True)
        assert _rows() - before == 2
    assert _bits_equal(got, want)
    for k in want_taps:
        assert _bits_equal(got_taps[k], want_taps[k]), k
    assert kb.bn_act.launches == 0


def test_every_block_takes_the_fused_code(on_card, monkeypatch):
    """One wrapper call a stem and three a block: 1 + 3 x 16 on R50."""
    calls = []

    def spy(*args):
        calls.append(len(args))
        return kb.bn_act_plain(*args)

    monkeypatch.setattr(resnet, "bn_act", spy)
    model = resnet.make_model("resnet50")
    with torch.inference_mode():
        model(torch.zeros(1, 3, 32, 32))
    # the stem and bn1 / bn2 without a residual, 12 identity skips, 4
    # downsampled
    assert len(calls) == 1 + 3 * 16
    assert sorted(set(calls)) == [3, 4, 6]
    assert calls.count(4) == 12 and calls.count(6) == 4


def test_each_module_dispatches_on_its_own_input(on_card, monkeypatch):
    """A channels-last view at the input (one image permuted from HWC, as
    a prediction gets it): the stem keeps the separate ops, and each
    block, whose input comes out contiguous, takes the fused pass."""
    calls = []

    def spy(*args):
        calls.append(len(args))
        return kb.bn_act_plain(*args)

    monkeypatch.setattr(resnet, "bn_act", spy)
    model = resnet.make_model("resnet50")
    x = torch.randn(32, 32, 3).permute(2, 0, 1)[None]
    before = _rows()
    with torch.inference_mode():
        model(x)
    assert not x.is_contiguous()
    assert len(calls) == 3 * 16 and _rows() == before


@pytest.mark.parametrize("case", ["grad_enabled", "guided_relu", "bf16"])
def test_other_forwards_take_the_plain_code(on_card, monkeypatch, case):
    """The IG sweep's forward and backward, guided backprop's rule and a
    bf16 cast keep the separate ops, on a card as on the CPU."""
    monkeypatch.setattr(resnet, "bn_act", lambda *a: pytest.fail(
        f"the {case} forward took the fused code"))
    model = _randomize_bn(resnet.make_model("resnet50"))
    x = torch.randn(1, 3, 32, 32)
    before = _rows()
    if case == "grad_enabled":
        x.requires_grad_(True)
        model(x)[0, 0].backward()
        assert x.grad is not None
    elif case == "guided_relu":
        with torch.inference_mode():
            resnet.set_relu(model, guided_relu)(x)
    else:
        with torch.inference_mode():
            model.to(torch.bfloat16)(x.to(torch.bfloat16))
    assert _rows() == before


def test_cpu_forward_takes_the_plain_code():
    """Without the stand-in the CPU never takes the fused code."""
    model = resnet.make_model("resnet50")
    before = _rows()
    with torch.inference_mode():
        model(torch.zeros(1, 3, 32, 32))
    assert _rows() == before and kb.bn_act.launches == 0


# --- on the card ----------------------------------------------------------

@pytest.mark.card
@pytest.mark.parametrize("form", sorted(FORMS))
@pytest.mark.parametrize("hw", PLANES, ids=[f"{h}x{w}" for h, w in PLANES])
def test_kernel_bit_exact_on_card(card, form, hw):
    args = [t.to(card) for t in _operands((3, 24, *hw), form, seed=3)]
    got = kb.bn_act(*args)
    want = kb.bn_act_plain(*args)
    torch.cuda.synchronize()
    assert kb.bn_act.launches == 1
    assert _bits_equal(got, want)


@pytest.mark.card
@pytest.mark.parametrize("form", sorted(FORMS))
@pytest.mark.parametrize("shape", [(1, 3, 1, 3), (3, 5, 13, 11),
                                   (2, 3, 7, 7)],
                         ids=["plane_under_4", "odd_count", "7x7_odd_count"])
def test_kernel_bit_exact_on_the_scalar_route(card, form, shape):
    """Planes under 4 elements and element counts that are no multiple
    of 4 take the scalar variant."""
    args = [t.to(card) for t in _operands(shape, form, seed=7)]
    assert _bits_equal(kb.bn_act(*args), kb.bn_act_plain(*args))


@pytest.mark.card
@pytest.mark.parametrize("form", sorted(FORMS))
def test_kernel_bit_exact_on_a_misaligned_view(card, form):
    """A contiguous view 4 bytes off a 16-byte boundary: the scalar
    variant on a 56x56 plane."""
    args = [t.to(card) for t in _operands((2, 8, 56, 56), form, seed=4)]
    buf = torch.empty(args[0].numel() + 1, device=card)
    buf[1:].copy_(args[0].view(-1))
    args[0] = buf[1:].view(args[0].shape)
    assert _bits_equal(kb.bn_act(*args), kb.bn_act_plain(*args))


@pytest.mark.card
def test_r101_forward_fused_equals_plain_on_card(card):
    model = _randomize_bn(resnet.make_model("resnet101")).to(card)
    plain = resnet.set_relu(resnet.make_model("resnet101"),
                            lambda t: F.relu(t))
    plain.load_state_dict(model.state_dict())
    plain.to(card)
    x = torch.randn(4, 3, 224, 224,
                    generator=torch.Generator().manual_seed(5)).to(card)
    with torch.inference_mode():
        before = _rows()
        got = model(x)
        assert kb.bn_act.launches == 100 and _rows() - before == 4
        want = plain(x)
        assert kb.bn_act.launches == 100
    assert _bits_equal(got, want)


@pytest.mark.card
@pytest.mark.parametrize("bad", ["dtype", "not_contiguous", "shape",
                                 "scale_device", "bn_without_residual"])
def test_wrapper_refuses_what_the_kernel_does_not_take(card, bad):
    x, scale, bias, residual, rs, rb = [
        t.to(card) for t in _operands((2, 4, 8, 8), "residual_bn", seed=6)]
    args = {"dtype": (x.double(), scale, bias),
            "not_contiguous": (x.transpose(2, 3), scale, bias),
            "shape": (x, scale, bias, residual[:1]),
            "scale_device": (x, scale.cpu(), bias),
            "bn_without_residual": (x, scale, bias, None, rs, rb)}[bad]
    with pytest.raises(ValueError):
        kb.bn_act(*args)
    assert kb.bn_act.launches == 0
