"""MaxViT on the perturbation path, on the CPU: a small torchvision-form
MaxViT against the benchmark's plain reference
(``portbench/reference/maxvit.py``) on the benchmark's seeded weights, the
reference against a torchvision-naming oracle, the counters, the dense
NHWC layout of both forms' activations, the zero image's gradient, and
one driver step.

The small MaxViT (``portbench/tests/configs/tiny_maxvit.json``) is 32 px,
stem 16, stages 2-1 at widths 16-32 of heads of 8, partition 4: stage
0's 8 x 8 map has 4 windows and 4 distinct grid groups, and stage 1's
4 x 4 map is one window.
"""
import json
import math
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn as nn

from portbench.images import image_pool
from portbench.reference import battery as ref_battery
from portbench.reference import ig as ref_ig
from portbench.reference import maxvit as ref_maxvit
from portbench.weights import make_weights
from xai_tpu_torch.convert import torch_import as TI
from xai_tpu_torch.convert.from_jax import state_dict_from_jax
from xai_tpu_torch.methods.batch import ig_lig_batch
from xai_tpu_torch.models import maxvit
from xai_tpu_torch.models.common import LayerNorm, ModelBundle, ModelMeta
from xai_tpu_torch.models.swin import WindowAttention
from xai_tpu_torch.registry import get_attribution
from xai_tpu_torch.runners import common as TC
from xai_tpu_torch.runners.evaluate_perturbation import kept_step
from xai_tpu_torch.utils import trace

from test_maxvit_convert import TVMaxVit
from test_torch_maxvit_card import small_maxvit
from torch_one_thread import one_torch_thread  # noqa: F401 (autouse)

PORTBENCH = Path(__file__).resolve().parent.parent / "portbench"
SEED = 2 ** 33 + 11
CPU = torch.device("cpu")


def _cfg(path):
    with open(path) as f:
        return json.load(f)


CFG = _cfg(PORTBENCH / "tests" / "configs" / "tiny_maxvit.json")
MAXVIT_T = _cfg(PORTBENCH / "configs" / "maxvit_t.json")


class _Ref:
    """The reference's forward over the benchmark's weights, as
    ``reference/ig.py`` calls it."""

    def __init__(self, cfg, w):
        self.cfg, self.w = cfg, w

    def forward(self, x):
        return ref_maxvit.forward(self.w, self.cfg, x)


@pytest.fixture(scope="module")
def small():
    """(program bundle, reference, normalized ``[B, H, W, C]`` images,
    the pool images)."""
    w = make_weights(ref_maxvit.param_spec(CFG), CFG["init"], SEED, CPU)
    module = maxvit.MaxViTTV(tuple(CFG["depths"]), tuple(CFG["dims"]),
                             CFG["stem_dim"], CFG["partition"],
                             CFG["head_dim"], CFG["num_classes"],
                             img_hw=CFG["img_hw"])
    module.load_state_dict(w)
    bundle = ModelBundle(ModelMeta(name="tiny_maxvit", family="cnn",
                                   img_hw=32, batch_size=25), module)
    imgs = image_pool({"pool": 3, "coarse_grid": 8, "noise": 0.15}, 32, SEED)
    xs = torch.stack([TC.normalize_input(i, "cnn", CPU) for i in imgs])
    return bundle, _Ref(CFG, w), xs, imgs


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


def _nchw(xs):
    return xs.permute(0, 3, 1, 2).contiguous()


def test_logits_match_the_reference(small):
    """Within 1e-5 of the largest |logit|: float32 rounding of the same
    arithmetic, in NHWC or NCHW, with the scale before or after ``q @
    k^T`` and LayerNorm's fast or two-pass variance (~2e-7 measured)."""
    bundle, ref, xs, _ = small
    with torch.no_grad():
        assert _rel(bundle.apply(_nchw(xs)), ref.forward(_nchw(xs))) < 1e-5


@pytest.mark.parametrize("path", ["registry", "batched"])
def test_ig_matches_the_reference(small, path):
    """IG-50 from the registry (image by image, 25-row chunks) and from
    ``ig_lig_batch`` (100-row chunks) within 1e-4 of the reference's map
    (one 50-row forward and backward), relative to its largest value:
    summation order over 50 gradients and the alphas' last bits."""
    bundle, ref, xs, imgs = small
    targets = [7, 500, 999]
    if path == "batched":
        got = ig_lig_batch(bundle, xs, torch.tensor(targets)).numpy()
    else:
        got = [get_attribution("cnn", "ig", TC.attr_context(bundle, {
            "x": xs[i], "trans_img": imgs[i], "target": t,
            "generator": None})) for i, t in enumerate(targets)]
    want = ref_ig.attribute(ref, _nchw(xs), targets, CFG).numpy()
    for g, r in zip(got, want):
        assert _rel(g, r) < 1e-4


def test_reference_matches_the_torchvision_oracle():
    """The reference on the weights of ``test_maxvit_convert.TVMaxVit``
    (torchvision's names and eval-time arithmetic, BatchNorm with its own
    running statistics, scale and shift), converted by the port's
    ``maxvit_from_torch`` and named as the port's state dict, at the size
    ``test_torch_convert.py`` builds it at (64 px, depths 1-1, 10
    classes): within 1e-5 of the largest |logit|, float32 rounding of
    BatchNorm folded or not and of the oracle's einsums (~2e-7
    measured)."""
    torch.manual_seed(0)
    oracle = TVMaxVit().eval()
    for m in oracle.modules():
        if isinstance(m, nn.BatchNorm2d):
            m.running_mean.normal_(0, 0.1)
            m.running_var.uniform_(0.6, 1.5)
            m.weight.data.uniform_(0.5, 1.5)
            m.bias.data.normal_(0, 0.1)
    w = {k: torch.as_tensor(v) for k, v in state_dict_from_jax(TI.flatten(
        TI.maxvit_from_torch(oracle.state_dict(), depths=(1, 1)))).items()}
    cfg = dict(CFG, img_hw=64, depths=[1, 1], num_classes=10)
    assert set(w) == {n for n, _, _ in ref_maxvit.param_spec(cfg)}
    x = torch.from_numpy(np.random.RandomState(1).randn(2, 3, 64, 64)
                         .astype(np.float32))
    with torch.no_grad():
        assert _rel(ref_maxvit.forward(w, cfg, x), oracle(x)) < 1e-5


def test_counters_follow_the_layers(small):
    """A row of the small model: window attention 64 + 64 + 16 query rows
    in its block and its grid layers alike (grid 64 + 64 + 16 of them);
    MBConv inputs of 16 x 16, 8 x 8 and 8 x 8 pixels."""
    bundle, _, xs, _ = small
    before = trace.counters()
    with torch.no_grad():
        bundle.apply(_nchw(xs))
    grew = {k: v - before.get(k, 0) for k, v in trace.counters().items()}
    assert grew["window_attn_rows"] == 3 * 2 * (64 + 64 + 16)
    assert grew["grid_attn_rows"] == 3 * (64 + 64 + 16)
    assert grew["mbconv_rows"] == 3 * (256 + 64 + 64)
    assert grew["mbconv_dense_rows"] == 3 * (256 + 64 + 64)
    assert grew["model_rows"] == 3
    assert grew.get("masked_window_rows", 0) == 0


@pytest.mark.parametrize("graph", [False, True], ids=["no_grad", "graph"])
@pytest.mark.parametrize("form", ["tv", "paper"])
def test_activations_are_dense_nhwc(form, graph):
    """From the stem on every activation is dense ``[B, H, W, C]`` memory,
    with or without a recorded graph: each MBConv, attention layer,
    LayerNorm and linear gets a contiguous input, ``mbconv_dense_rows``
    grows as ``mbconv_rows`` does, and the only batched products are the
    attention's two (``q @ k^T``, ``@ v``) a ``WindowAttention`` call: a
    linear on a strided 4-D input runs as a GEMM batched over image
    rows.  The 1x1 convolutions are GEMMs: 7 convolutions are left, the
    stem's 2, 3 depthwise and the 2 pooled shortcuts."""
    module = small_maxvit(form)
    kinds = (maxvit.MBConv, maxvit.MBConvTV, maxvit.AttnLayer, LayerNorm,
             nn.Linear, WindowAttention)
    inputs = []
    for name, mod in module.named_modules():
        if isinstance(mod, kinds):
            mod.register_forward_pre_hook(
                lambda mod, inp, name=name: inputs.append(
                    (name, type(mod), inp[0].is_contiguous())))
    x = torch.randn(2, 3, 32, 32, requires_grad=graph)
    before = trace.counters()
    with torch.set_grad_enabled(graph), \
            torch.autograd.profiler.profile() as prof:
        module(x)
    grew = {k: v - before.get(k, 0) for k, v in trace.counters().items()}
    assert {kind for _, kind, _ in inputs} == set(kinds) - {
        maxvit.MBConv if form == "tv" else maxvit.MBConvTV}
    assert [name for name, _, dense in inputs if not dense] == []
    assert grew["mbconv_dense_rows"] == grew["mbconv_rows"] == \
        2 * (256 + 64 + 64)
    attn_calls = sum(kind is WindowAttention for _, kind, _ in inputs)
    assert attn_calls == 6
    ops = [e.name for e in prof.function_events]
    assert ops.count("aten::bmm") == 2 * attn_calls
    assert ops.count("aten::conv2d") == 7


def test_maxvit_t_counts_per_row():
    """At maxvit_t's 224 px, from one 1-row forward on the meta device:
    17,836 window-attention query rows (2 x 3136 + 2 x 784 + 5 x 196 + 2 x
    49, block and grid), 8,918 of them grid; 21,413 MBConv input pixels
    (12544 + 3136 + 3136 + 784 + 784 + 4 x 196 + 196 + 49)."""
    with torch.device("meta"):
        bundle = TC.build_bundle("MAXVIT", device="meta")
        before = trace.counters()
        with torch.no_grad():
            bundle.apply(torch.empty(1, 3, 224, 224))
    grew = {k: v - before.get(k, 0) for k, v in trace.counters().items()}
    assert grew["window_attn_rows"] == 17836
    assert grew["grid_attn_rows"] == 8918
    assert grew["mbconv_rows"] == 21413
    assert grew.get("masked_window_rows", 0) == 0


def test_zoo_route_builds_maxvit_t_at_published_shapes():
    """``model_entry`` reads the bundle's meta; ``build_bundle`` gives the
    zoo's MaxViT-T, whose state dict is the reference's ``param_spec`` at
    ``configs/maxvit_t.json``, name for name and shape for shape:
    30,919,624 parameters and 5,558,046,720 MACs (torchvision's 30.9 M and
    5.56 G)."""
    assert TC.model_entry("MAXVIT") == ("cnn", 25)
    with torch.device("meta"):
        bundle = TC.build_bundle("MAXVIT", device="meta")
    assert bundle.meta.name == "MAXVIT" and bundle.meta.family == "cnn"
    got = {k: tuple(v.shape) for k, v in bundle.module.state_dict().items()}
    want = {k: tuple(s) for k, s, _ in ref_maxvit.param_spec(MAXVIT_T)}
    assert got == want
    assert sum(math.prod(s) for s in want.values()) == 30919624
    assert ref_maxvit.macs(MAXVIT_T) == 5558046720


def test_zero_image_gradient_is_finite_at_maxvit_t_depth():
    """IG's first row is the zero image.  At maxvit_t's depth and 224 px
    (widths cut to 16-32-32-64, heads of 16), the benchmark's weights
    give it a finite input gradient; with every bias zero, every
    activation is 0 and the gradient overflows through the LayerNorms in
    series."""
    cfg = dict(MAXVIT_T, stem_dim=16, dims=[16, 32, 32, 64], head_dim=16)
    spec = ref_maxvit.param_spec(cfg)
    zero_biases = [(n, s, "zero" if k == "shift" else k)
                   for n, s, k in spec]
    for spec_, finite in ((spec, True), (zero_biases, False)):
        w = make_weights(spec_, cfg["init"], 7, CPU)
        x = torch.zeros(1, 3, 224, 224, requires_grad=True)
        ref_maxvit.forward(w, cfg, x)[0, 3].backward()
        assert bool(torch.isfinite(x.grad).all()) is finite


def test_kept_step_scores_match_the_reference_battery(small):
    """One batched driver step of two images (IG, then the battery on the
    1x1 mesh of the CPU): each image's 10 scores are the reference
    battery's of the program's map, within 1e-5."""
    bundle, ref, xs, imgs = small
    blur = TC.default_blur()
    with torch.no_grad():
        targets = bundle.apply(_nchw(xs[:2])).argmax(-1).tolist()
    pend = [{"x": xs[i], "trans_img": imgs[i], "target": targets[i],
             "generator": TC.image_generator(0, i, CPU)} for i in range(2)]
    sals, scores, _ = kept_step(bundle, "cnn", pend, blur, "ig")
    assert sals.shape == (2, 32, 32)
    for i in range(2):
        want = ref_battery.scores(ref.forward, _nchw(xs[i:i + 1])[0],
                                  sals[i], targets[i], 31, 31.0)
        assert set(scores[i]) == set(want)
        for k in want:
            assert scores[i][k] == pytest.approx(want[k], abs=1e-5), k
