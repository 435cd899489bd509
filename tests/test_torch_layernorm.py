"""The fused LayerNorm (``xai_tpu_torch/kernels/layernorm.py``) and the
gate of ``models/common.py LayerNorm`` that takes it.

On the CPU: the plain version against the module's op chain bit for bit,
the gate's rule, the module's fused code path (the wrapper runs its plain
version on CPU tensors) against its plain code, and the two row counters.
The tests marked ``card`` hold the CUDA kernel against the plain version
and a float64 LayerNorm and skip without a card; on a machine with one,
run them without this directory's JAX conftest:

    python -m pytest tests/test_torch_layernorm.py --noconftest -m card -q
"""
import math

import pytest
import torch

from xai_tpu_torch.kernels import layernorm as kl
from xai_tpu_torch.models import common, swin, vit
from xai_tpu_torch.models.common import LayerNorm
from xai_tpu_torch.utils import trace

from torch_one_thread import one_torch_thread  # noqa: F401 (autouse)

# every width the cells run: Swin-B's blocks and patch merging (128 to
# 2048) and ViT-B/16's 768; then widths whose quads do not fill a warp's
# lanes (MaxViT's and PVT's 64, ConvNeXt's 96, PVT's 320)
WIDTHS = [128, 256, 512, 768, 1024, 2048]
OTHER_WIDTHS = [64, 96, 320]
# ragged row counts, and ViT-B/16's rows of one 180-row forward
ROWS = [1, 31, 33, 35460]
OTHER_ROWS = [1, 33, 1000]
TINY_VIT = vit.ViTConfig(patch=8, embed_dim=32, depth=2, num_heads=4,
                         mlp_ratio=2.0, num_classes=16, img_hw=32)
TINY_SWIN = dict(depths=(2, 2), num_heads=(2, 4), embed_dim=16, window=4,
                 img_hw=32)


@pytest.fixture
def card():
    """The first CUDA card, or a skip."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.fixture(autouse=True)
def _zero_launches():
    kl.layernorm.launches = 0
    yield


def _rows():
    c = trace.counters()
    return c.get("layernorm_rows", 0), c.get("layernorm_fused_rows", 0)


def _op_chain(x, scale, bias, eps):
    """The module's separate ops, as models/common.py LayerNorm wrote
    them before the fused kernel."""
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    var = ((x32 * x32).mean(-1, keepdim=True) - mu * mu).clamp(min=0.0)
    mul = torch.rsqrt(var + eps) * scale.float()
    y = (x32 - mu) * mul + bias.float()
    return y.to(torch.promote_types(x.dtype, scale.dtype))


def _float64_ln(x, scale, bias, eps):
    """flax's formula in float64."""
    x = x.double()
    mu = x.mean(-1, keepdim=True)
    var = ((x * x).mean(-1, keepdim=True) - mu * mu).clamp(min=0.0)
    return (x - mu) * (torch.rsqrt(var + eps) * scale.double()) \
        + bias.double()


def _operands(rows, c, seed=0, dtype=torch.float32, offset=0.3):
    """x [rows, c] with a per-row spread and a per-row offset (normal, of
    deviation ``offset``), as a residual stream has; at ``offset`` 0 each
    row centred on 0 (in float64, then rounded); scale and bias near 1
    and 0."""
    gen = torch.Generator().manual_seed(seed)
    x = (torch.randn(rows, c, generator=gen, dtype=torch.float64)
         * (0.5 + torch.rand(rows, 1, generator=gen, dtype=torch.float64))
         + offset * torch.randn(rows, 1, generator=gen, dtype=torch.float64))
    if not offset:
        x = x - x.mean(-1, keepdim=True)
    scale = 1 + 0.2 * torch.randn(c, generator=gen)
    bias = 0.2 * torch.randn(c, generator=gen)
    return x.to(dtype), scale, bias


def _bits_equal(got, want):
    return (got.shape == want.shape and got.dtype == want.dtype
            and torch.equal(got.contiguous().view(torch.uint8),
                            want.contiguous().view(torch.uint8)))


def _ulp(m: float) -> float:
    """One float32 ulp at magnitude ``m``."""
    return 2.0 ** (math.floor(math.log2(m)) - 23)


class _OnCard:
    """A CPU tensor as the gate sees a card's: every attribute the
    tensor's but ``is_cuda``."""
    is_cuda = True

    def __init__(self, x):
        self._x = x

    def __getattr__(self, name):
        return getattr(self._x, name)


def _gate_sees_cards(monkeypatch):
    """The gate with CPU tensors counted as a card's: the module takes its
    fused code, whose wrapper calls run the plain version on the CPU."""
    rule = common._fused_layernorm
    monkeypatch.setattr(common, "_fused_layernorm",
                        lambda x, s, b: rule(_OnCard(x), s, b))


@pytest.fixture
def on_card(monkeypatch):
    _gate_sees_cards(monkeypatch)


def _random_norms(model, seed):
    """``model`` with every LayerNorm's scale and bias drawn at random."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, LayerNorm):
                m.scale.copy_(1 + 0.2 * torch.randn(m.scale.shape,
                                                    generator=gen))
                m.bias.copy_(0.2 * torch.randn(m.bias.shape, generator=gen))
    return model


def _tiny_vit():
    return _random_norms(vit.init_random(vit.VisionTransformer(TINY_VIT),
                                         seed=1), 1)


def _tiny_swin():
    return _random_norms(common.init_flax_default(
        swin.SwinTransformer(num_classes=16, **TINY_SWIN), seed=2), 2)


# --- the plain version ----------------------------------------------------

@pytest.mark.parametrize("x_dtype,p_dtype", [
    (torch.float32, torch.float32), (torch.bfloat16, torch.float32),
    (torch.bfloat16, torch.bfloat16), (torch.float64, torch.float32)],
    ids=["f32", "bf16_x", "bf16", "f64_x"])
@pytest.mark.parametrize("c", [96, 768])
def test_plain_equals_the_module_op_chain(x_dtype, p_dtype, c):
    x, scale, bias = _operands(7, c, seed=c, dtype=x_dtype)
    scale, bias = scale.to(p_dtype), bias.to(p_dtype)
    x[2, 5] = math.nan
    x[4, 1] = math.inf
    got = kl.layernorm_plain(x, scale, bias, 1e-5)
    assert _bits_equal(got, _op_chain(x, scale, bias, 1e-5))
    assert bool(torch.isnan(got[2]).all()) and bool(
        torch.isfinite(got[0]).all())


def test_cpu_call_runs_the_plain_version():
    x, scale, bias = _operands(15, 64, seed=1)
    x = x.view(5, 3, 64)
    assert _bits_equal(kl.layernorm(x, scale, bias, 1e-6),
                       kl.layernorm_plain(x, scale, bias, 1e-6))
    assert kl.layernorm.launches == 0


def test_module_forward_is_the_plain_version_on_the_cpu():
    ln = LayerNorm(320, eps=1e-6)
    x, scale, bias = _operands(9, 320, seed=2)
    with torch.no_grad():
        ln.scale.copy_(scale)
        ln.bias.copy_(bias)
        assert _bits_equal(ln(x), _op_chain(x, scale, bias, 1e-6))


# --- the gate -------------------------------------------------------------

def _gate_operands(case):
    x, scale, bias = _operands(6, {"width_6": 6, "width_2052": 2052}.get(
        case, 128), seed=3)
    if case == "bf16":
        x = x.bfloat16()
    elif case == "not_contiguous":
        x = x.t().contiguous().t()
    elif case == "misaligned":
        buf = torch.empty(x.numel() + 1)
        buf[1:].copy_(x.view(-1))
        x = buf[1:].view(x.shape)
    elif case == "scale_bf16":
        scale = scale.bfloat16()
    return x, scale, bias


@pytest.mark.parametrize("case,fused", [
    ("card_f32_inference", True), ("card_f32_no_grad", True),
    ("grad_enabled", False), ("cpu", False), ("bf16", False),
    ("not_contiguous", False), ("width_6", False), ("width_2052", False),
    ("misaligned", False), ("scale_bf16", False)])
def test_gate_rule(case, fused):
    x, scale, bias = _gate_operands(case)
    if case != "cpu":
        x = _OnCard(x)
    if case == "grad_enabled":
        with torch.enable_grad():
            assert common._fused_layernorm(x, scale, bias) is fused
    elif case == "card_f32_no_grad":
        with torch.no_grad():
            assert common._fused_layernorm(x, scale, bias) is fused
    else:
        with torch.inference_mode():
            assert common._fused_layernorm(x, scale, bias) is fused


@pytest.mark.parametrize("case", ["grad_enabled", "bf16", "not_contiguous",
                                  "width_6", "cpu"])
def test_module_keeps_the_separate_ops(on_card, monkeypatch, case):
    """Under grad (the IG sweep), for bf16, a non-contiguous input (Swin's
    patch norm on the CPU), an unsupported width, and on the CPU without
    the stand-in, the module never calls the kernel's wrapper, and counts
    the rows as unfused."""
    if case == "cpu":
        monkeypatch.undo()
    monkeypatch.setattr(common, "layernorm", lambda *a: pytest.fail(
        f"the {case} call took the fused code"))
    x, scale, bias = _gate_operands(case)
    ln = LayerNorm(x.shape[-1], eps=1e-5)
    with torch.no_grad():
        ln.scale.copy_(scale.float())
        ln.bias.copy_(bias)
    if case == "bf16":
        ln.bfloat16()
    rows, fused = _rows()
    if case == "grad_enabled":
        x.requires_grad_(True)
        ln(x).sum().backward()
        assert x.grad is not None
    else:
        with torch.inference_mode():
            got = ln(x)
        assert _bits_equal(got, _op_chain(x, ln.scale, ln.bias, 1e-5))
    assert _rows() == (rows + 6, fused)


@pytest.mark.parametrize("arch", ["vit", "swin"])
def test_fused_code_matches_plain_code(monkeypatch, arch):
    """A forward that records no graph sends every contiguous LayerNorm
    call to the wrapper (here its plain version), bit for bit the plain
    forward's logits; both counters count token rows: ViT 2 x depth + 1
    norms of every token; Swin's patch norm gets a strided NHWC view of
    the patch convolution on the CPU (on a card the forward makes it
    contiguous), and its output, the first stage's residual stream, keeps
    that layout, so only the rows from the patch merging on are fused."""
    model = _tiny_vit() if arch == "vit" else _tiny_swin()
    x = torch.randn(3, 3, 32, 32, generator=torch.Generator().manual_seed(4))
    with torch.inference_mode():
        want = model(x)             # the CPU: the separate ops
    calls = []

    def spy(x, scale, bias, eps):
        calls.append(x.shape[-1])
        return kl.layernorm(x, scale, bias, eps)

    _gate_sees_cards(monkeypatch)
    monkeypatch.setattr(common, "layernorm", spy)
    rows, fused = _rows()
    with torch.inference_mode():
        got = model(x)
    rows, fused = _rows()[0] - rows, _rows()[1] - fused
    assert _bits_equal(got, want)
    if arch == "vit":
        assert len(calls) == 2 * TINY_VIT.depth + 1
        assert rows == fused == len(calls) * 3 * TINY_VIT.tokens
    else:
        # per image: patch norm 64 rows (C 16), 2 blocks x 2 x 64 (C 16),
        # patch merging 16 (C 64), 2 x 2 x 16 (C 32), the final norm 16
        assert rows == 3 * (64 + 256 + 16 + 64 + 16)
        assert fused == 3 * (16 + 64 + 16)
        assert sorted(set(calls)) == [32, 64] and len(calls) == 6
    assert kl.layernorm.launches == 0


def test_counters_count_token_rows_with_no_fused_share_on_the_cpu():
    model = _tiny_vit()
    rows, fused = _rows()
    with torch.inference_mode():
        model(torch.zeros(2, 3, 32, 32))
    assert _rows()[0] - rows == (2 * TINY_VIT.depth + 1) * 2 * \
        TINY_VIT.tokens
    assert _rows()[1] == fused and kl.layernorm.launches == 0


# --- on the card ----------------------------------------------------------

def _launch(card, rows, c, offset):
    """(kernel, plain version, float64 LayerNorm) of one call's operands,
    the kernel one launch."""
    x, scale, bias = (t.to(card) for t in _operands(
        rows, c, seed=c + rows, offset=offset))
    before = kl.layernorm.launches
    got = kl.layernorm(x, scale, bias, 1e-5)
    torch.cuda.synchronize()
    assert kl.layernorm.launches - before == 1
    assert got.dtype == torch.float32 and got.shape == x.shape
    return (got, kl.layernorm_plain(x, scale, bias, 1e-5),
            _float64_ln(x, scale, bias, 1e-5))


@pytest.mark.card
@pytest.mark.parametrize("rows,c", [(r, c) for c in WIDTHS for r in ROWS]
                         + [(r, c) for c in OTHER_WIDTHS
                            for r in OTHER_ROWS])
def test_kernel_matches_plain_on_card(card, rows, c):
    """Centred rows: within 4 ulps of the plain version's largest |y|,
    from which only the order of the two sums sets it apart."""
    got, want, _ = _launch(card, rows, c, offset=0.0)
    top = want.abs().max().item()
    assert (got - want).abs().max().item() <= 4 * _ulp(top)


@pytest.mark.card
@pytest.mark.parametrize("c", WIDTHS + OTHER_WIDTHS)
@pytest.mark.parametrize("offset", [0.0, 0.3], ids=["centred", "offset"])
def test_kernel_error_against_float64_on_card(card, c, offset):
    """The kernel's error against a float64 LayerNorm, root mean square
    over a width's ragged row counts together, at most twice the plain
    version's.  Not the largest error: with row offsets the fast variance
    E[x^2] - mean^2 cancels digits, so the largest is one draw of a few
    roundings in the worst-conditioned row, and two orders of the same
    sums may differ there by more than 4 ulps (which is why offset rows
    are held here only)."""
    sq_kernel = sq_plain = 0.0
    for rows in ROWS if c in WIDTHS else OTHER_ROWS:
        got, want, exact = _launch(card, rows, c, offset)
        sq_kernel += ((got.double() - exact) ** 2).sum().item()
        sq_plain += ((want.double() - exact) ** 2).sum().item()
    assert math.sqrt(sq_kernel) <= 2 * math.sqrt(sq_plain)


@pytest.mark.card
def test_kernel_passes_nan_and_inf_rows_as_plain_does(card):
    x, scale, bias = (t.to(card) for t in _operands(40, 768, seed=5))
    x[3, 7] = math.nan
    x[9, 0] = math.inf
    x[11] = 0.0
    got = kl.layernorm(x, scale, bias, 1e-6)
    want = kl.layernorm_plain(x, scale, bias, 1e-6)
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    assert bool(torch.isnan(got[3]).all() and torch.isnan(got[9]).all())
    assert torch.equal(got[11], want[11])


@pytest.mark.card
@pytest.mark.parametrize("bad", ["dtype", "not_contiguous", "width_6",
                                 "width_2052", "misaligned", "scale_shape",
                                 "scale_device"])
def test_wrapper_refuses_what_the_kernel_does_not_take(card, bad):
    x, scale, bias = (t.to(card) for t in _operands(8, 256, seed=6))
    if bad in ("width_6", "width_2052"):
        x = torch.zeros(8, int(bad[6:]), device=card)
    args = {"dtype": (x.double(), scale, bias),
            "not_contiguous": (x.t().contiguous().t(), scale, bias),
            "width_6": (x, scale[:6].contiguous(), bias[:6].contiguous()),
            "width_2052": (x, torch.ones(2052, device=card),
                           torch.zeros(2052, device=card)),
            "misaligned": (torch.zeros(8 * 256 + 1, device=card)[1:]
                           .view(8, 256), scale, bias),
            "scale_shape": (x, scale[:128], bias),
            "scale_device": (x, scale.cpu(), bias)}[bad]
    with pytest.raises(ValueError):
        kl.layernorm(*args, 1e-5)
    assert kl.layernorm.launches == 0


@pytest.mark.card
def test_forwards_take_the_kernel_on_card(card):
    """A ViT forward under inference launches once a LayerNorm (2 x depth
    + 1), Swin's too (its patch norm made contiguous), within rounding of
    the same forward's separate ops; the IG sweep's kind of forward
    launches nothing."""
    x = torch.randn(2, 3, 32, 32,
                    generator=torch.Generator().manual_seed(7)).to(card)
    for model, norms in ((_tiny_vit(), 2 * TINY_VIT.depth + 1),
                         (_tiny_swin(), 11)):
        model.to(card)
        kl.layernorm.launches = 0
        with torch.inference_mode():
            got = model(x)
        assert kl.layernorm.launches == norms
        want = model(x)             # records a graph: the separate ops
        assert kl.layernorm.launches == norms
        assert torch.allclose(got, want.detach(), rtol=1e-4, atol=1e-5)
