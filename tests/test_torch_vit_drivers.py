"""The ViT family through every ported driver of xai_tpu_torch, against
xai_tpu's drivers on the CPU.

``--model TINY_VIT`` with xai_tpu's 32 px test ViT put into both
packages' constructors (``CONFIGS["vit_tiny_patch16_224"]``, with
monkeypatch; the constructors give it 1000 classes, as the drivers
expect) and one xai_tpu ``.npz`` as ``--params_path``.  The perturbation
CSV, the sanity CSV and the segmentation TXT must be within 2e-3 of
xai_tpu's, the driver tolerance of the CNN cases.  The sanity cases carry
xai_tpu's randomized ViT through ``.npz`` and inject it into the port's
randomizer, so both drivers attribute the same two models.
"""
import copy
import csv
import json
import os

import jax
import numpy as np
import pytest
import torch

from xai_tpu.models import vit as jvit
from xai_tpu.runners import evaluate_imagenet_seg as JG
from xai_tpu.runners import evaluate_perturbation as JP
from xai_tpu.runners import evaluate_sanity as JS
from xai_tpu.runners import image_finder as JF
from xai_tpu.runners.common import build_bundle as jax_build_bundle
from xai_tpu.runners.common import save_params

from xai_tpu_torch.convert.from_jax import load_params
from xai_tpu_torch.data.imagenet import ImageNetValStream
from xai_tpu_torch.models import vit as tvit
from xai_tpu_torch.models.common import ModelBundle
from xai_tpu_torch.registry import get_attribution
from xai_tpu_torch.runners import common as TC
from xai_tpu_torch.runners import evaluate_imagenet_seg as TG
from xai_tpu_torch.runners import evaluate_perturbation as TP
from xai_tpu_torch.runners import evaluate_sanity as TS
from xai_tpu_torch.runners import image_finder as TF
from xai_tpu_torch.runners import qualitative_generation as TQ
from xai_tpu_torch.runners import sweep as TW

from test_torch_vit import CFG32
from torch_one_thread import one_torch_thread  # noqa: F401 (autouse)

RUNTIME_ROWS = ("Attr Avg Runtime", "Total Runtime")
# 3 images a class: one batch of two and a tail of one
BATCHED = ["--image_batch", "2", "--image_count", "3000"]


@pytest.fixture(scope="module", autouse=True)
def vit32():
    """The 32 px config in both packages' TINY_VIT constructor."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(jvit.CONFIGS, "vit_tiny_patch16_224",
                   jvit.ViTConfig(**CFG32))
        mp.setitem(tvit.CONFIGS, "vit_tiny_patch16_224",
                   tvit.ViTConfig(**CFG32))
        yield


@pytest.fixture(scope="module")
def jax_params():
    return jax_build_bundle("TINY_VIT", seed=2).params


@pytest.fixture(scope="module")
def params_path(jax_params, tmp_path_factory):
    return save_params(jax_params, str(
        tmp_path_factory.mktemp("params") / "tiny_vit.npz"))


def _rows(path):
    with open(path) as f:
        return {r[0]: float(r[1]) for r in csv.reader(f) if r}


def _pert(tmp_path, pkg, params_path, flags):
    d = tmp_path / f"{pkg}{len(os.listdir(tmp_path))}"
    mod = JP if pkg == "jax" else TP
    args = mod.build_parser().parse_args(
        ["--model", "TINY_VIT", "--params_path", params_path,
         "--synthetic", "3", *flags, "--output_dir", str(d)])
    if pkg == "jax":
        mod.evaluate_perturbation(args)
    else:
        mod.evaluate_perturbation(args, device="cpu")
    rows = _rows(d / "TINY_VIT" / f"{args.attr_func}_{args.image_count}"
                                  f"_images.csv")
    return {k: v for k, v in rows.items() if k not in RUNTIME_ROWS}


def _within(got, ref, tol):
    assert list(got) == list(ref), (list(got), list(ref))
    for k in ref:
        assert abs(got[k] - ref[k]) < tol, (k, got[k], ref[k])
        assert np.isfinite(got[k]), k


@pytest.mark.parametrize("name,batched", [
    ("rollout", False), ("t_attr", False), ("bi_attn", False),
    ("t_attr", True), ("attn_ig", True)],
    ids=["rollout", "t_attr", "bi_attn", "t_attr_batched",
         "attn_ig_batched"])
def test_pert_csv_matches_xai_tpu(tmp_path, params_path, name, batched):
    flags = ["--attr_func", name] + (BATCHED if batched
                                     else ["--image_count", "3"])
    ref = _pert(tmp_path, "jax", params_path, flags)
    got = _pert(tmp_path, "torch", params_path, flags)
    assert len(got) == 10
    _within(got, ref, 2e-3)


def test_pert_bf16_contract(tmp_path, params_path):
    """--attr_dtype bf16 on the batched path moves the scores by less than
    0.05 from float32: xai_tpu's driver contract for bf16."""
    flags = ["--attr_func", "rollout", *BATCHED]
    f32 = _pert(tmp_path, "torch", params_path, flags)
    bf16 = _pert(tmp_path, "torch", params_path,
                 flags + ["--attr_dtype", "bf16"])
    _within(bf16, f32, 0.05)


@pytest.fixture(scope="module")
def rand_path(jax_params, tmp_path_factory):
    # the JAX driver's randomization at --seed 0
    rand = JS.randomize_family(jax_params, "vit", jax.random.PRNGKey(1))
    return save_params(rand, str(tmp_path_factory.mktemp("params")
                                 / "tiny_vit_rand.npz"))


def _injected(path):
    def randomize(bundle, family, generator):
        module = copy.deepcopy(bundle.module)
        module.load_state_dict(load_params(path))
        return ModelBundle(bundle.meta, module)
    return randomize


def _sanity(tmp_path, pkg, flags):
    d = tmp_path / f"{pkg}{len(os.listdir(tmp_path))}"
    mod = JS if pkg == "jax" else TS
    args = mod.build_parser().parse_args(
        ["--model", "TINY_VIT", *flags, "--output_dir", str(d)])
    if pkg == "jax":
        mod.evaluate_sanity(args)
    else:
        mod.evaluate_sanity(args, device="cpu")
    rows = _rows(d / "TINY_VIT" / f"{args.attr_func}_{args.image_count}"
                                  f"_images.csv")
    del rows["Total Runtime"]
    return rows


@pytest.mark.parametrize("name,batch", [("rollout", 1), ("t_attr", 1),
                                        ("t_attr", 2)],
                         ids=["rollout", "t_attr", "t_attr_batched"])
def test_sanity_csv_matches_xai_tpu(tmp_path, monkeypatch, params_path,
                                    rand_path, name, batch):
    """Three images; batched: one batch of two and a flushed tail.  At
    32 px HOG has 2 x 2 cells and no 3 x 3 block, so its Spearman is NaN
    in both packages alike (the 48 px case below holds it)."""
    monkeypatch.setattr(TS, "randomize_family", _injected(rand_path))
    flags = ["--attr_func", name, "--synthetic", "3", "--image_count", "3",
             "--image_batch", str(batch), "--params_path", params_path]
    ref = _sanity(tmp_path, "jax", flags)
    got = _sanity(tmp_path, "torch", flags)
    assert list(got) == list(ref) == ["SSIM", "SPR", "HOG"]
    for k in ref:
        if np.isnan(ref[k]):
            assert np.isnan(got[k]), (k, got[k])
        else:
            assert abs(got[k] - ref[k]) < 2e-3, (k, got[k], ref[k])


def test_sanity_csv_with_hog_matches_xai_tpu(tmp_path, monkeypatch):
    """The same driver on the test ViT's widths at 48 px (a 6 x 6 patch
    grid; HOG has one block), so that all three scores are held."""
    cfg48 = dict(CFG32, img_hw=48)
    monkeypatch.setitem(jvit.CONFIGS, "vit_tiny_patch16_224",
                        jvit.ViTConfig(**cfg48))
    monkeypatch.setitem(tvit.CONFIGS, "vit_tiny_patch16_224",
                        tvit.ViTConfig(**cfg48))
    params = jax_build_bundle("TINY_VIT", seed=3).params
    path = save_params(params, str(tmp_path / "p.npz"))
    rand = save_params(JS.randomize_family(params, "vit",
                                           jax.random.PRNGKey(1)),
                       str(tmp_path / "r.npz"))
    monkeypatch.setattr(TS, "randomize_family", _injected(rand))
    out = tmp_path / "runs"
    out.mkdir()
    flags = ["--attr_func", "rollout", "--synthetic", "2", "--image_count",
             "2", "--params_path", path]
    ref = _sanity(out, "jax", flags)
    assert all(np.isfinite(v) for v in ref.values()), ref
    _within(_sanity(out, "torch", flags), ref, 2e-3)


def _seg(tmp_path, pkg, flags):
    d = tmp_path / f"{pkg}{len(os.listdir(tmp_path))}"
    mod = JG if pkg == "jax" else TG
    args = mod.build_parser().parse_args(
        ["--model", "TINY_VIT", *flags, "--output_dir", str(d)])
    if pkg == "jax":
        scores = mod.evaluate_imagenet_seg(args)
    else:
        scores = mod.evaluate_imagenet_seg(args, device="cpu")
    with open(d / "TINY_VIT" / f"{args.attr_func}_{args.image_count}"
                               f"_images") as f:
        assert len(f.read().splitlines()) == 4
    return scores


@pytest.mark.parametrize("name,batch", [("rollout", 1), ("t_attr", 2)],
                         ids=["rollout", "t_attr_batched"])
def test_seg_txt_matches_xai_tpu(tmp_path, params_path, name, batch):
    flags = ["--attr_func", name, "--synthetic", "3", "--image_batch",
             str(batch), "--params_path", params_path]
    _within(_seg(tmp_path, "torch", flags), _seg(tmp_path, "jax", flags),
            2e-3)


def test_image_finder_mask_matches_xai_tpu(tmp_path, params_path):
    bundle = TC.build_bundle("TINY_VIT", params_path, device="cpu")
    xs = torch.stack([TC.normalize_input(it.trans_img, "vit", "cpu")
                      for it in ImageNetValStream("", 32, synthetic=6)])
    preds = TC.predict_classes(bundle, xs)
    gt = tmp_path / "gt.txt"
    gt.write_text("".join(f"{p if i % 2 == 0 else (p + 1) % 1000}\n"
                          for i, p in enumerate(preds)))
    flags = ["--model", "TINY_VIT", "--synthetic", "6", "--batch_size", "4",
             "--ground_truth", str(gt), "--params_path", params_path]
    ref = JF.find_correctly_classified(JF.build_parser().parse_args(
        flags + ["--class_maps_dir", str(tmp_path / "jax")]))
    got = TF.find_correctly_classified(TF.build_parser().parse_args(
        flags + ["--class_maps_dir", str(tmp_path / "torch")]),
        device="cpu")
    assert got.tolist() == ref.tolist() == [1, 0] * 3


# --- TIS, VIT_CX, MDA and MDA_dense through the drivers ---

# TIS draws its 1024 initial centroids without replacement from the
# depth x width activation rows, so its model needs 1024 of them (the
# 32 px test ViT has 64): the test ViT's patches at 4 blocks of 256.
# With as many masks as rows every row is its own centroid, whatever the
# draw, so the two packages' TIS maps agree without injected randomness.
CFG_TIS = dict(CFG32, embed_dim=256, depth=4)


@pytest.fixture()
def tis_vit(tmp_path, monkeypatch):
    """--model TINY_VIT as CFG_TIS in both packages; its params' path."""
    monkeypatch.setitem(jvit.CONFIGS, "vit_tiny_patch16_224",
                        jvit.ViTConfig(**CFG_TIS))
    monkeypatch.setitem(tvit.CONFIGS, "vit_tiny_patch16_224",
                        tvit.ViTConfig(**CFG_TIS))
    return save_params(jax_build_bundle("TINY_VIT", seed=2).params,
                       str(tmp_path / "tis_vit.npz"))


@pytest.fixture()
def shared_vit_cx_noise(monkeypatch):
    """ViT-CX's noise, injected into both packages: the k-th image either
    package attributes draws numpy's RandomState(k) at its cluster
    count."""
    from xai_tpu.methods import vit_cx as JX
    from xai_tpu_torch.methods import vit_cx as TX

    def noise(k, count):
        return (np.random.RandomState(len(count)).randn(k, 32, 32, 3)
                * 0.1).astype(np.float32)

    def jax_vit_cx(bundle, x, target=None, key=None, dtype=None,
                   count=[], real=JX.vit_cx):
        _, tri, _ = JX._masks_and_sim_jit(bundle.apply_taps, bundle.params,
                                          jax.numpy.asarray(x)[None], 32)
        k = int(JX._cluster_host(np.asarray(tri), bundle.extras.embed_dim,
                                 0.1).max()) + 1
        count.append(None)
        return real(bundle, x, target, noise=noise(k, count), dtype=dtype)

    def torch_vit_cx(bundle, x, target=None, generator=None, dtype=None,
                     count=[], real=TX.vit_cx):
        sim = TX._masks_and_sim(bundle, x.permute(2, 0, 1)[None])[1]
        k = int(TX.cluster_host(sim[0].numpy(), 0.1).max()) + 1
        count.append(None)
        return real(bundle, x, target, noise=noise(k, count), dtype=dtype)

    monkeypatch.setattr(JX, "vit_cx", jax_vit_cx)
    monkeypatch.setattr(TX, "vit_cx", torch_vit_cx)


def test_vit_panel_fails_only_the_slice2_names(tis_vit):
    """The 11-name ViT panel (named when VIT_CX, TIS and MDA still failed,
    naming A10 slice 2): now no name fails; every map is the registry's
    with the panel's generator, and MDA's (no randomness) xai_tpu's."""
    from xai_tpu.registry import AttrContext as JCtx
    from xai_tpu.registry import get_attribution as jax_get_attribution

    bundle = TC.build_bundle("TINY_VIT", tis_vit, device="cpu")
    item = next(iter(ImageNetValStream("", 32, synthetic=1)))
    maps, failed = TQ.panel_maps(bundle, item, TQ.VIT_PANEL, 3, "cpu")
    assert not failed and sorted(maps) == sorted(TQ.VIT_PANEL)
    x = TC.normalize_input(item.trans_img, "vit", "cpu")
    target = TC.predict_classes(bundle, x[None])[0]
    for name, m in maps.items():
        ref = get_attribution("vit", name, TC.attr_context(bundle, {
            "x": x, "trans_img": item.trans_img, "target": target,
            "generator": TC.image_generator(3, item.index, "cpu")}))
        assert m.shape == (32, 32) and np.array_equal(m, ref), name
    jb = jax_build_bundle("TINY_VIT", tis_vit)
    ref = jax_get_attribution("vit", "MDA", JCtx(
        bundle=jb, x=jax.numpy.asarray(x.numpy()), trans_img=item.trans_img,
        target=target, key=jax.random.PRNGKey(0), img_hw=32))
    np.testing.assert_allclose(maps["MDA"], ref,
                               atol=1e-4 * float(np.abs(ref).max()))


def test_sweep_runs_vit_rows(tmp_path, monkeypatch, tis_vit):
    """The ViT rollout and TIS rows run in every driver (a TIS row named
    A10 slice 2 before); the pert and seg rows' scores match xai_tpu's
    sweep on the same weights (each driver's bundle built from
    ``tis_vit``: the sweep takes no --params_path)."""
    from xai_tpu.runners import sweep as JW

    def same_weights(real):
        return lambda model, params_path="", *a, **k: real(
            model, params_path or tis_vit, *a, **k)

    for mod in (JP, JG, TP, TS, TG):
        monkeypatch.setattr(mod, "build_bundle",
                            same_weights(mod.build_bundle))
    argv = ["--models", "TINY_VIT", "--methods", "rollout,TIS",
            "--synthetic", "1", "--image_count", "1"]
    records = TW.run_sweep(TW.build_parser().parse_args(
        argv + ["--drivers", "pert,sanity,seg", "--output_dir",
                str(tmp_path / "torch")]), device="cpu")
    assert [(r["driver"], r["attr_func"], r["status"]) for r in records] == [
        (d, m, "ok") for d in ("pert", "sanity", "seg")
        for m in ("rollout", "TIS")]
    JW.run_sweep(JW.build_parser().parse_args(
        argv + ["--drivers", "pert,seg", "--output_dir",
                str(tmp_path / "jax")]))
    with open(tmp_path / "jax" / "sweep_manifest.jsonl") as f:
        ref = {(r["driver"], r["attr_func"]): r
               for r in map(json.loads, f)}
    for r in records:
        if r["driver"] == "sanity":
            assert list(r["scores"]) == ["SSIM", "SPR", "HOG"]
            continue
        want = ref[r["driver"], r["attr_func"]]
        assert want["status"] == "ok", want
        _within(r["scores"], want["scores"], 2e-3)


@pytest.mark.parametrize("model", ["VIT16", "VIT32", "TINY_VIT"])
def test_vit_models_are_ported(model):
    """No driver's model lookup raises for a ViT, nor, since A11, for a
    CLIP: every model of xai_tpu's drivers' table is in the port's."""
    assert TC.model_entry(model)[0] == "vit"
    assert TC.model_entry("CLIP16") == ("clip", 25)
    assert TC.model_entry("CLIP32") == ("clip", 50)
    from xai_tpu.runners.common import MODEL_TABLE
    assert TC.MODEL_TABLE == MODEL_TABLE


def test_vit_entry_points_raise_without_cuda(tmp_path):
    """A ViT bundle or driver asked for no device runs on CUDA or raises;
    it never falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this checks the behaviour on a machine without CUDA")
    with pytest.raises(RuntimeError, match="CUDA"):
        TC.build_bundle("TINY_VIT")
    args = TP.build_parser().parse_args(
        ["--model", "TINY_VIT", "--attr_func", "rollout", "--synthetic",
         "1", "--image_count", "1", "--output_dir", str(tmp_path)])
    with pytest.raises(RuntimeError, match="CUDA"):
        TP.evaluate_perturbation(args)
    assert not os.listdir(tmp_path)
