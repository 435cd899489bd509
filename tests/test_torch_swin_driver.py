"""Swin on the perturbation path, on the CPU: a small Swin against
the benchmark's plain reference (``portbench/reference/swin.py``) on the
benchmark's seeded weights, the drivers' route to the zoo's names, the
windowed-attention counters, and one driver step.

The small Swin is 32 px, width 16, stages 2-2 of 2-4 heads, window 4: its
stage 0 has a shifted, masked block, and its stage 1's window covers the
4 x 4 grid, so that stage's shift is dropped, as Swin-B's last stage's is
at 224 px.
"""
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xai_tpu.models import swin as jsw
from xai_tpu.runners.common import MODEL_TABLE as JAX_MODEL_TABLE
from xai_tpu.runners.common import save_params

from portbench.images import image_pool
from portbench.reference import battery as ref_battery
from portbench.reference import ig as ref_ig
from portbench.reference import swin as ref_swin
from portbench.weights import make_weights
from xai_tpu_torch.methods.batch import ig_lig_batch
from xai_tpu_torch.models import swin
from xai_tpu_torch.models.common import ModelBundle, ModelMeta
from xai_tpu_torch.registry import get_attribution
from xai_tpu_torch.runners import common as TC
from xai_tpu_torch.runners.evaluate_perturbation import kept_step
from xai_tpu_torch.utils import trace

from torch_one_thread import one_torch_thread  # noqa: F401 (autouse)

PORTBENCH = Path(__file__).resolve().parent.parent / "portbench"
SEED = 2 ** 33 + 5
CPU = torch.device("cpu")
SMALL = dict(depths=(2, 2), num_heads=(2, 4), embed_dim=16, window=4,
             img_hw=32)


def _cfg(path):
    with open(path) as f:
        return json.load(f)


CFG = _cfg(PORTBENCH / "tests" / "configs" / "tiny_swin.json")
SWIN_B = _cfg(PORTBENCH / "configs" / "swin_b.json")


class _Ref:
    """The reference's forward over the benchmark's weights, as
    ``reference/ig.py`` calls it."""

    def __init__(self, cfg, w):
        self.cfg, self.w = cfg, w

    def forward(self, x):
        return ref_swin.forward(self.w, self.cfg, x)


@pytest.fixture(scope="module")
def small():
    """(program bundle, reference, normalized ``[B, H, W, C]`` images,
    the pool images)."""
    w = make_weights(ref_swin.param_spec(CFG), CFG["init"], SEED, CPU)
    module = swin.SwinTransformer(num_classes=1000, **SMALL)
    module.load_state_dict(w)
    bundle = ModelBundle(ModelMeta(name="tiny_swin", family="cnn",
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
    arithmetic, with the scale before or after ``q @ k^T`` and LayerNorm's
    fast or two-pass variance (~3e-7 measured)."""
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


def test_counters_follow_the_windows(small):
    """Each call adds windows x tokens a window; only stage 0's second
    block carries a shift mask."""
    bundle, _, xs, _ = small
    before = trace.counters()
    with torch.no_grad():
        bundle.apply(_nchw(xs))
    grew = {k: v - before.get(k, 0) for k, v in trace.counters().items()}
    per_row = 2 * 8 * 8 + 2 * 4 * 4
    assert grew["window_attn_rows"] == 3 * per_row
    assert grew["masked_window_rows"] == 3 * 8 * 8
    assert grew["model_rows"] == 3


def test_swin_base_counts_per_row():
    """11,466 query rows a row at Swin-B 224 px (3,136 x 2 + 784 x 2 +
    196 x 18 + 49 x 2), 5,684 masked (the last stage's shift is dropped),
    from one 1-row forward on the meta device."""
    with torch.device("meta"):
        bundle = TC.build_bundle("swin_base", device="meta")
        before = trace.counters()
        with torch.no_grad():
            bundle.apply(torch.empty(1, 3, 224, 224))
    grew = {k: v - before.get(k, 0) for k, v in trace.counters().items()}
    assert grew["window_attn_rows"] == 11466
    assert grew["masked_window_rows"] == 5684


def test_zoo_route_builds_swin_base_at_published_shapes():
    """``model_entry`` reads the bundle's meta; ``build_bundle`` gives the
    zoo's Swin-B, whose state dict is the reference's ``param_spec`` at
    ``configs/swin_b.json``, name for name and shape for shape."""
    assert TC.model_entry("swin_base") == ("cnn", 25)
    with torch.device("meta"):
        bundle = TC.build_bundle("swin_base", device="meta")
    assert bundle.meta.name == "swin_base" and bundle.meta.family == "cnn"
    got = {k: tuple(v.shape) for k, v in bundle.module.state_dict().items()}
    want = {k: tuple(s) for k, s, _ in ref_swin.param_spec(SWIN_B)}
    assert got == want
    assert sum(np.prod(s) for s in want.values()) == 87768224
    assert ref_swin.macs(SWIN_B) == 15430946816


def test_model_table_is_still_xai_tpus():
    assert TC.MODEL_TABLE == JAX_MODEL_TABLE
    assert "swin_base" not in TC.MODEL_TABLE
    with pytest.raises(KeyError):
        TC.model_entry("no_such_model")


def test_zoo_route_loads_params_path(tmp_path, monkeypatch):
    """``--params_path`` for a zoo name goes through ``load_params``: a
    small xai_tpu Swin saved by xai_tpu's ``save_params`` gives the port's
    bundle xai_tpu's logits."""
    jm = jsw.SwinTransformer(depths=(2, 2), num_heads=(2, 4), embed_dim=16,
                             window=4, num_classes=1000)
    x = np.random.RandomState(3).randn(2, 32, 32, 3).astype(np.float32)
    params = jm.init(jax.random.PRNGKey(2), jnp.asarray(x))["params"]
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    path = save_params(params, str(tmp_path / "swin.npz"))
    monkeypatch.setitem(swin.ARCHS, "swin_tiny", SMALL)
    bundle = TC.build_bundle("swin_tiny", path, device=CPU)
    with torch.no_grad():
        got = bundle.apply(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()))
    assert _rel(got, want) < 1e-5


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
