"""ConvNeXt on the perturbation path, on the CPU: a small ConvNeXt against
the benchmark's plain reference (``portbench/reference/convnext.py``) on
the benchmark's seeded weights, the reference against the torchvision-form
oracle of ``test_convnext.py``, the block counter, the zero image's
gradient at convnext_base depth, and one driver step.

The small ConvNeXt (``portbench/tests/configs/tiny_convnext.json``) is 32
px, a 4x4 stem to 16, stages 2-1 at widths 16-32: stage 1's 2x2
downsampling runs on an 8 x 8 grid, and its 4 x 4 grid is smaller than
the 7x7 depthwise kernel, so the kernel's zero padding counts.
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
from portbench.reference import convnext as ref_convnext
from portbench.reference import ig as ref_ig
from portbench.weights import make_weights
from xai_tpu_torch.convert import torch_import as TI
from xai_tpu_torch.convert.from_jax import state_dict_from_jax
from xai_tpu_torch.methods.batch import ig_lig_batch
from xai_tpu_torch.models import convnext
from xai_tpu_torch.models.common import ModelBundle, ModelMeta
from xai_tpu_torch.registry import get_attribution
from xai_tpu_torch.runners import common as TC
from xai_tpu_torch.runners.evaluate_perturbation import kept_step
from xai_tpu_torch.utils import trace

from test_convnext import TorchCNBlock, TorchConvNeXt
from torch_one_thread import one_torch_thread  # noqa: F401 (autouse)

PORTBENCH = Path(__file__).resolve().parent.parent / "portbench"
SEED = 2 ** 33 + 13
CPU = torch.device("cpu")


def _cfg(path):
    with open(path) as f:
        return json.load(f)


CFG = _cfg(PORTBENCH / "tests" / "configs" / "tiny_convnext.json")
CONVNEXT_B = _cfg(PORTBENCH / "configs" / "convnext_b.json")


class _Ref:
    """The reference's forward over the benchmark's weights, as
    ``reference/ig.py`` calls it."""

    def __init__(self, cfg, w):
        self.cfg, self.w = cfg, w

    def forward(self, x):
        return ref_convnext.forward(self.w, self.cfg, x)


@pytest.fixture(scope="module")
def small():
    """(program bundle, reference, normalized ``[B, H, W, C]`` images,
    the pool images)."""
    w = make_weights(ref_convnext.param_spec(CFG), CFG["init"], SEED, CPU)
    module = convnext.ConvNeXt(CFG["depths"], CFG["dims"],
                               CFG["num_classes"])
    module.load_state_dict(w)
    bundle = ModelBundle(ModelMeta(name="tiny_convnext", family="cnn",
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
    arithmetic, channels-last views or NCHW, and LayerNorm's fast or
    two-pass variance."""
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
    """The reference on the weights of ``test_convnext.TorchConvNeXt``
    (torchvision's names, ``LayerNorm2d`` permutes and ``CNBlock`` layer
    scale, nonzero biases, layer scales drawn from [0.5, 1.5]; its stem,
    downsampling and head norms set to torchvision's eps of 1e-6, where
    the oracle keeps ``nn.LayerNorm``'s 1e-5), converted by the port's
    ``convnext_from_torch`` and named as the port's state dict, at the
    small model's size with 10 classes: within 1e-5 of the largest
    |logit|, float32 rounding of the same arithmetic in another order."""
    torch.manual_seed(0)
    depths, dims = tuple(CFG["depths"]), tuple(CFG["dims"])
    oracle = TorchConvNeXt(depths, dims, 10).eval()
    for m in oracle.modules():
        if isinstance(m, TorchCNBlock):
            m.layer_scale.data.uniform_(0.5, 1.5)
        elif isinstance(m, nn.LayerNorm):
            m.eps = 1e-6
    w = {k: torch.as_tensor(v) for k, v in state_dict_from_jax(TI.flatten(
        TI.convnext_from_torch(oracle.state_dict(), depths))).items()}
    cfg = dict(CFG, num_classes=10)
    assert {k: tuple(v.shape) for k, v in w.items()} == {
        n: tuple(s) for n, s, _ in ref_convnext.param_spec(cfg)}
    x = torch.from_numpy(np.random.RandomState(1).randn(2, 3, 32, 32)
                         .astype(np.float32))
    with torch.no_grad():
        assert _rel(ref_convnext.forward(w, cfg, x), oracle(x)) < 1e-5


def test_counter_follows_the_blocks(small):
    """A row of the small model: two blocks on 8 x 8 pixels and one on 4 x
    4, every one on dense memory."""
    bundle, _, xs, _ = small
    before = trace.counters()
    with torch.no_grad():
        bundle.apply(_nchw(xs))
    grew = {k: v - before.get(k, 0) for k, v in trace.counters().items()}
    assert grew["cnblock_rows"] == 3 * (2 * 64 + 16)
    assert grew["cnblock_dense_rows"] == grew["cnblock_rows"]
    assert grew["model_rows"] == 3


def test_convnext_base_counts_per_row():
    """At convnext_base's 224 px, from one 1-row forward on the meta
    device: 17,199 block pixels (3 x 56² + 3 x 28² + 27 x 14² + 3 x
    7²), every one on dense memory."""
    with torch.device("meta"):
        bundle = TC.build_bundle("CONVNXT", device="meta")
        before = trace.counters()
        with torch.no_grad():
            bundle.apply(torch.empty(1, 3, 224, 224))
    grew = {k: v - before.get(k, 0) for k, v in trace.counters().items()}
    assert grew["cnblock_rows"] == 17199 == \
        3 * 56 ** 2 + 3 * 28 ** 2 + 27 * 14 ** 2 + 3 * 7 ** 2
    assert grew["cnblock_dense_rows"] == 17199


def test_zoo_route_builds_convnext_base_at_published_shapes():
    """``model_entry`` reads the bundle's meta; ``build_bundle`` gives the
    zoo's ConvNeXt-B, whose state dict is the reference's ``param_spec``
    at ``configs/convnext_b.json``, name for name and shape for shape:
    88,591,464 parameters and 15,354,729,472 MACs (torchvision's 88.6 M
    and 15.35 G)."""
    assert TC.model_entry("CONVNXT") == ("cnn", 50)
    with torch.device("meta"):
        bundle = TC.build_bundle("CONVNXT", device="meta")
    assert bundle.meta.name == "convnext_base" and bundle.meta.family == "cnn"
    got = {k: tuple(v.shape) for k, v in bundle.module.state_dict().items()}
    want = {k: tuple(s) for k, s, _ in ref_convnext.param_spec(CONVNEXT_B)}
    assert got == want
    assert sum(math.prod(s) for s in want.values()) == 88591464
    assert ref_convnext.macs(CONVNEXT_B) == 15354729472


def test_zero_image_gradient_is_finite_at_convnext_base_depth():
    """IG's first row is the zero image.  At convnext_base's depth and 224
    px (widths cut to 16-32-32-64), the benchmark's weights give it a
    finite input gradient; with every bias zero, every activation is 0
    and the gradient overflows through the LayerNorms in series."""
    cfg = dict(CONVNEXT_B, dims=[16, 32, 32, 64])
    spec = ref_convnext.param_spec(cfg)
    zero_biases = [(n, s, "zero" if k == "shift" else k)
                   for n, s, k in spec]
    for spec_, finite in ((spec, True), (zero_biases, False)):
        w = make_weights(spec_, cfg["init"], 7, CPU)
        x = torch.zeros(1, 3, 224, 224, requires_grad=True)
        ref_convnext.forward(w, cfg, x)[0, 3].backward()
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
