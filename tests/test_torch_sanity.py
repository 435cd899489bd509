"""The sanity metrics, the weight randomization and the sanity driver of
xai_tpu_torch against xai_tpu's, on the CPU.

The metrics are host numpy in both packages, so they agree to float64
rounding.  The randomized weights cannot: xai_tpu draws them with
jax.random, the port with a torch.Generator.  The driver cases carry
xai_tpu's randomized weights through ``.npz`` and inject them into the
port's randomizer, so both drivers attribute the same two models.
"""
import copy
import csv
import math
import os

import jax
import numpy as np
import pytest
import torch

from xai_tpu.metrics import sanity as JS
from xai_tpu.runners import evaluate_sanity as JD
from xai_tpu.runners.common import build_bundle as jax_build_bundle
from xai_tpu.runners.common import save_params

from xai_tpu_torch.convert.from_jax import load_params, state_dict_from_jax
from xai_tpu_torch.metrics import sanity as TS
from xai_tpu_torch.models.common import ModelBundle
from xai_tpu_torch.runners import common as TC
from xai_tpu_torch.runners import evaluate_sanity as TD

from torch_one_thread import one_torch_thread  # noqa: F401 (autouse)


def _maps(kind, rs, shape=(32, 32, 3)):
    if kind == "constant":
        return np.full(shape, 0.25, np.float32)
    if kind == "inf":
        a = rs.randn(*shape).astype(np.float32)
        a[3, 4] = np.inf
        a[5, 6] = -np.inf
        return a
    if kind == "ties":
        return np.round(rs.rand(*shape), 1).astype(np.float32)
    return rs.randn(*shape).astype(np.float32)


KINDS = ["random", "ties", "constant", "inf"]


@pytest.mark.parametrize("kind", KINDS)
def test_normalize_image_matches_xai_tpu(kind):
    a = _maps(kind, np.random.RandomState(1))
    got, ref = TS.normalize_image(a), JS.normalize_image(a)
    assert got.dtype == ref.dtype and np.abs(got - ref).max() <= 1e-10


@pytest.mark.parametrize("shape", [(64, 56), (48, 48, 3)])
@pytest.mark.parametrize("kind", ["random", "ties", "constant"])
def test_ssim_and_hog_match_xai_tpu(kind, shape):
    rs = np.random.RandomState(2)
    a, b = _maps(kind, rs, shape), _maps("random", rs, shape)
    assert abs(TS.ssim(a, b) - JS.ssim(a, b)) <= 1e-10
    assert abs(TS.ssim(a, a) - JS.ssim(a, a)) <= 1e-10
    got, ref = TS.hog(a), JS.hog(a)
    assert got.shape == ref.shape and np.abs(got - ref).max() <= 1e-10


@pytest.mark.parametrize("kind", KINDS)
def test_evaluate_matches_xai_tpu(kind):
    rs = np.random.RandomState(3)
    a, b = _maps(kind, rs, (64, 64, 3)), _maps("random", rs, (64, 64, 3))
    for got, ref in zip(TS.evaluate(a, b), JS.evaluate(a, b)):
        if np.isnan(ref):
            assert np.isnan(got)
        else:
            assert abs(got - ref) <= 1e-10, (got, ref)


@pytest.fixture(scope="module")
def jax_params():
    return jax_build_bundle("TINY_R", seed=2).params


@pytest.fixture(scope="module")
def params_path(jax_params, tmp_path_factory):
    return save_params(jax_params, str(
        tmp_path_factory.mktemp("params") / "tiny_r.npz"))


def test_top_level_layers_are_xai_tpus(jax_params):
    state = TC.build_bundle("TINY_R", device="cpu").module.state_dict()
    ref = [k.replace("_", ".") if k.startswith("layer") else k
           for k in JS.top_level_layers(jax_params)]
    assert TS.top_level_layers(state) == ref


def test_randomize_params_draws_uniform_from_the_generator():
    state = {"conv1.weight": torch.zeros(4, 3, 2, 2),
             "layer1.0.bn1.scale": torch.zeros(4),
             "layer1.10.bn1.scale": torch.zeros(4),
             "fc.bias": torch.zeros(7)}
    gen = torch.Generator().manual_seed(5)
    out = TS.randomize_params(state, gen, ["layer1.0."])
    assert torch.equal(out["layer1.0.bn1.scale"],
                       torch.rand(4, generator=torch.Generator()
                                  .manual_seed(5)))
    for name in ("conv1.weight", "layer1.10.bn1.scale", "fc.bias"):
        assert out[name] is state[name]
    everything = TS.randomize_params(state, torch.Generator().manual_seed(5))
    for t in everything.values():
        assert bool(((t >= 0) & (t < 1)).all()) and t.abs().sum() > 0


def test_cascading_and_independent_randomize_pick_their_groups():
    state = TC.build_bundle("TINY_R", device="cpu").module.state_dict()
    layers = TS.top_level_layers(state)
    casc = TS.cascading_randomize(state, torch.Generator().manual_seed(0), 2)
    hit = {n for n in state if not torch.equal(casc[n], state[n])}
    assert {TS._GROUP.match(n).group(1) for n in hit} == set(layers[:3])
    one = TS.independent_randomize(state, torch.Generator().manual_seed(0),
                                   "layer2.0")
    hit = {n for n in state if not torch.equal(one[n], state[n])}
    assert hit and all(n.startswith("layer2.0.") for n in hit)


def test_randomize_family_changes_exactly_the_kernel_images(params_path):
    """The randomized tensors are the images of xai_tpu's ``kernel``
    leaves under the weight carry, each within its bound, and the draws
    are the generator's, in the module's parameter order."""
    with np.load(params_path) as flat:
        kernels = {k: flat[k] for k in flat.files if k.endswith("kernel")}
    expected = set(state_dict_from_jax(kernels))
    bundle = TC.build_bundle("TINY_R", params_path, device="cpu")
    rand = TD.randomize_family(bundle, "cnn",
                               torch.Generator().manual_seed(1))
    before = bundle.module.state_dict()
    after = rand.module.state_dict()
    changed = {n for n in before if not torch.equal(before[n], after[n])}
    assert changed == expected
    gen = torch.Generator().manual_seed(1)
    for name, w in rand.module.named_parameters():
        if name not in expected:
            continue
        if w.dim() == 4:
            bound = math.sqrt(6.0 / (w.shape[1] * w.shape[2] * w.shape[3]))
        else:
            bound = math.sqrt(6.0 / (w.shape[0] + w.shape[1]))
        assert float(w.abs().max()) <= bound
        assert torch.equal(w, torch.rand(w.shape, generator=gen)
                           * (2 * bound) - bound)
    # the input bundle is left as it was
    assert all(torch.equal(before[n], t) for n, t in
               bundle.module.state_dict().items())


def test_randomize_family_is_deterministic_in_the_seed():
    bundle = TC.build_bundle("TINY_R", device="cpu")

    def draw(seed):
        return TD.randomize_family(bundle, "cnn", torch.Generator()
                                   .manual_seed(seed)).module.state_dict()

    a, b, c = draw(3), draw(3), draw(4)
    assert all(torch.equal(a[n], b[n]) for n in a)
    assert not torch.equal(a["conv1.weight"], c["conv1.weight"])
    with pytest.raises(NotImplementedError, match="A10"):
        TD.randomize_family(bundle, "vit", torch.Generator())


def _injected(path):
    """A randomizer that loads xai_tpu's randomized weights."""
    def randomize(bundle, family, generator):
        module = copy.deepcopy(bundle.module)
        module.load_state_dict(load_params(path))
        return ModelBundle(bundle.meta, module)
    return randomize


@pytest.fixture(scope="module")
def rand_path(jax_params, tmp_path_factory):
    # the JAX driver's randomization at --seed 0
    rand = JD.randomize_family(jax_params, "cnn", jax.random.PRNGKey(1))
    return save_params(rand, str(tmp_path_factory.mktemp("params")
                                 / "tiny_r_rand.npz"))


def _read(path):
    with open(path) as f:
        return {r[0]: float(r[1]) for r in csv.reader(f) if r}


def _run(pkg, tmp_path, flags, model="TINY_R"):
    d = tmp_path / f"{pkg}{len(os.listdir(tmp_path))}"
    mod = JD if pkg == "jax" else TD
    args = mod.build_parser().parse_args(
        ["--model", model, *flags, "--output_dir", str(d)])
    if pkg == "jax":
        mod.evaluate_sanity(args)
    else:
        mod.evaluate_sanity(args, device="cpu")
    rows = _read(d / model / f"{args.attr_func}_{args.image_count}"
                              f"_images.csv")
    assert list(rows) == ["SSIM", "SPR", "HOG", "Total Runtime"]
    del rows["Total Runtime"]
    return rows


@pytest.mark.parametrize("batch", [1, 2], ids=["per_image", "batched"])
@pytest.mark.parametrize("name", ["ig", "gc"])
def test_sanity_csv_matches_xai_tpu(tmp_path, monkeypatch, params_path,
                                    rand_path, name, batch):
    """Three images; batched: one batch of two and a flushed tail."""
    monkeypatch.setattr(TD, "randomize_family", _injected(rand_path))
    flags = ["--attr_func", name, "--synthetic", "3", "--image_count", "3",
             "--image_batch", str(batch), "--params_path", params_path]
    ref = _run("jax", tmp_path, flags)
    got = _run("torch", tmp_path, flags)
    for k in ref:
        # the driver CSV tolerance of tests/test_torch_driver.py
        assert abs(got[k] - ref[k]) < 2e-3, (k, got[k], ref[k])
        assert np.isfinite(got[k])


@pytest.mark.parametrize("batch", [1, 2], ids=["per_image", "batched"])
def test_both_weight_sets_draw_the_same_noise(tmp_path, monkeypatch, batch):
    """A stochastic method's two attributions of an image (trained and
    randomized weights) each get a fresh generator of (seed, index), so
    they draw alike, as xai_tpu's one key does; images draw apart."""
    draws = []

    def record(gen):
        draws.append(torch.rand(8, generator=gen))

    def entry(family, name, ctx):
        record(ctx.generator)
        return np.random.RandomState(len(draws)).rand(64, 64)

    def batched(family, name, bundle, xs, trans, targets, gens, **kw):
        for g in gens:
            record(g)
        return np.random.RandomState(len(draws)).rand(len(gens), 64, 64)

    monkeypatch.setattr(TD, "get_attribution", entry)
    monkeypatch.setattr(TC, "batch_attribution", batched)
    TD.evaluate_sanity(TD.build_parser().parse_args(
        ["--model", "TINY_R", "--attr_func", "sg", "--synthetic", "2",
         "--image_count", "2", "--image_batch", str(batch),
         "--output_dir", str(tmp_path)]), device="cpu")
    # per image: (img0 trained, img0 random, img1 ...); batched: (img0,
    # img1 trained), (img0, img1 random)
    order = [0, 1, 2, 3] if batch == 1 else [0, 2, 1, 3]
    d = [draws[i] for i in order]
    assert len(draws) == 4
    assert torch.equal(d[0], d[1]) and torch.equal(d[2], d[3])
    assert not torch.equal(d[0], d[2])


def test_sanity_bf16_contract(tmp_path, monkeypatch):
    """--attr_dtype bf16 moves the sanity scores by less than 0.05 from
    float32 and from xai_tpu's bf16 run: xai_tpu's driver contract for
    bf16 (tests/test_image_batch_runner.py), on its configuration
    (TINY_CNN at 224 px, two images in one batch)."""
    params = jax_build_bundle("TINY_CNN").params
    path = save_params(params, str(tmp_path / "tiny_cnn.npz"))
    rand = save_params(JD.randomize_family(params, "cnn",
                                           jax.random.PRNGKey(1)),
                       str(tmp_path / "tiny_cnn_rand.npz"))
    monkeypatch.setattr(TD, "randomize_family", _injected(rand))
    out = tmp_path / "runs"
    out.mkdir()
    flags = ["--attr_func", "ig", "--image_batch", "2", "--synthetic", "2",
             "--image_count", "2", "--params_path", path]
    bf16 = flags + ["--attr_dtype", "bf16"]
    f32 = _run("torch", out, flags, "TINY_CNN")
    got = _run("torch", out, bf16, "TINY_CNN")
    ref = _run("jax", out, bf16, "TINY_CNN")
    for k in f32:
        assert abs(f32[k] - got[k]) < 0.05, (k, f32[k], got[k])
        assert abs(ref[k] - got[k]) < 0.05, (k, ref[k], got[k])


def test_sanity_shard_images_raises(tmp_path):
    args = TD.build_parser().parse_args(
        ["--model", "TINY_R", "--synthetic", "1", "--image_count", "1",
         "--output_dir", str(tmp_path), "--shard_images"])
    with pytest.raises(NotImplementedError, match="A14"):
        TD.evaluate_sanity(args, device="cpu")
    assert not os.listdir(tmp_path)
