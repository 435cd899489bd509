"""The CLIP family through every ported driver of xai_tpu_torch, against
xai_tpu's drivers on the CPU.

``--model CLIP16`` with the driver-sized tiny CLIP
(``test_torch_clip.CLIP_DRIVER``: the widths of xai_tpu's test CLIP with
the real vocabulary and context, so that each package's build_bundle
tokenizes and encodes the real 1000-prompt table) put into both packages'
``CONFIGS`` with monkeypatch, and one xai_tpu ``.npz`` as
``--params_path``.  The perturbation CSV, the sanity CSV (xai_tpu's
randomized CLIP carried through ``.npz`` and injected, the text table
rebuilt by the port) and the segmentation TXT must be within 2e-3 of
xai_tpu's, image by image and at ``--image_batch 2``.

eclip, eclip_nograd, eclip_wo and grad_cam are relu maps of a 4 x 4
patch grid upsampled to 32 px: their maps match xai_tpu's within 1e-4
of the max (``test_torch_clip_methods.py``), but the last bits reorder
near-equal pixels in the battery's ranking, 32 pixels a reveal step, and
the discrete scores (MONO) and MAS then move by more than 2e-3, where
the same map gives equal scores in both packages.  Their driver cases
here feed xai_tpu's maps into the port's driver (``shared_maps``), which
holds everything around the map.
"""
import copy
import csv
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xai_tpu.methods import batch as JBT
from xai_tpu.models import clip as jclip
from xai_tpu.registry import AttrContext as JCtx
from xai_tpu.registry import get_attribution as jax_attr
from xai_tpu.runners import common as JC
from xai_tpu.runners import evaluate_imagenet_seg as JG
from xai_tpu.runners import evaluate_perturbation as JP
from xai_tpu.runners import evaluate_sanity as JS
from xai_tpu.runners import image_finder as JF
from xai_tpu.runners import qualitative_generation as JQ
from xai_tpu.runners.common import save_params

from xai_tpu_torch import registry as TREG
from xai_tpu_torch.convert.from_jax import load_params
from xai_tpu_torch.data.imagenet import ImageNetValStream
from xai_tpu_torch.models import clip as tclip
from xai_tpu_torch.registry import get_attribution
from xai_tpu_torch.runners import common as TC
from xai_tpu_torch.runners import evaluate_imagenet_seg as TG
from xai_tpu_torch.runners import evaluate_perturbation as TP
from xai_tpu_torch.runners import evaluate_sanity as TS
from xai_tpu_torch.runners import image_finder as TF
from xai_tpu_torch.runners import qualitative_generation as TQ
from xai_tpu_torch.runners import sweep as TW

from test_torch_clip import CLIP_DRIVER
from torch_one_thread import one_torch_thread  # noqa: F401 (autouse)

RUNTIME_ROWS = ("Attr Avg Runtime", "Total Runtime")
# 3 images, two of one class: one batch of two and a tail of one
BATCHED = ["--image_batch", "2", "--image_count", "3000"]
# relu maps whose battery scores are ill-conditioned in the map's last
# bits at 32 px (module docstring)
NEAR_TIES = ("eclip", "eclip_nograd", "eclip_wo", "grad_cam")


def _use(monkeypatch, cfg):
    for configs, cls in ((jclip.CONFIGS, jclip.CLIPConfig),
                         (tclip.CONFIGS, tclip.CLIPConfig)):
        monkeypatch.setitem(configs, "clip_vit_b16", cls(**cfg))


@pytest.fixture(scope="module", autouse=True)
def clip32():
    """The driver-sized tiny CLIP in both packages' CLIP16 constructor."""
    with pytest.MonkeyPatch.context() as mp:
        _use(mp, CLIP_DRIVER)
        yield


@pytest.fixture(scope="module")
def jax_params():
    return JC.build_bundle("CLIP16", seed=2).params


@pytest.fixture(scope="module")
def params_path(jax_params, tmp_path_factory):
    return save_params(jax_params, str(
        tmp_path_factory.mktemp("params") / "clip16.npz"))


def _rows(path):
    with open(path) as f:
        return {r[0]: float(r[1]) for r in csv.reader(f) if r}


def _pert(tmp_path, pkg, params_path, flags):
    d = tmp_path / f"{pkg}{len(os.listdir(tmp_path))}"
    mod = JP if pkg == "jax" else TP
    args = mod.build_parser().parse_args(
        ["--model", "CLIP16", "--params_path", params_path,
         "--synthetic", "3", *flags, "--output_dir", str(d)])
    if pkg == "jax":
        mod.evaluate_perturbation(args)
    else:
        mod.evaluate_perturbation(args, device="cpu")
    rows = _rows(d / "CLIP16" / f"{args.attr_func}_{args.image_count}"
                                f"_images.csv")
    return {k: v for k, v in rows.items() if k not in RUNTIME_ROWS}


def _within(got, ref, tol):
    assert list(got) == list(ref), (list(got), list(ref))
    for k in ref:
        assert abs(got[k] - ref[k]) < tol, (k, got[k], ref[k])
        assert np.isfinite(got[k]), k


@pytest.fixture()
def shared_maps(monkeypatch, params_path):
    """The port's drivers fed xai_tpu's maps: its registry entries and
    batch_attribution (as the drivers call them) return xai_tpu's, for
    the same image, target and caption."""
    jb = JC.build_bundle("CLIP16", params_path)

    def one(name, c):
        return jax_attr("clip", name, JCtx(
            bundle=jb, x=jnp.asarray(c.x.numpy()), trans_img=c.trans_img,
            target=c.target, key=jax.random.PRNGKey(0), img_hw=c.img_hw,
            extras=JC.clip_extras(jb, c.target)))

    def batch(family, name, bundle, xs, trans, targets, gens, img_hw=224,
              dtype=None, extras=None, **_):
        ex = [JC.clip_extras(jb, int(t)) for t in targets]
        return JBT.batch_attribution(
            family, name, jb, xs.numpy(), trans, np.asarray(targets),
            np.stack([np.asarray(jax.random.PRNGKey(0))] * len(targets)),
            extras={k: np.concatenate([np.asarray(e[k]) for e in ex])
                    for k in ex[0]}, img_hw=img_hw)

    for name in NEAR_TIES:
        monkeypatch.setitem(TREG.CLIP_METHODS, name,
                            lambda c, name=name: one(name, c))
    monkeypatch.setattr(TC, "batch_attribution", batch)


@pytest.mark.parametrize("name,batched", [
    ("game", False), ("lrp", False), ("maskclip", False),
    ("selfattn", False), ("rollout", False), ("surgery", False),
    ("game", True), ("lrp", True), ("maskclip", True), ("selfattn", True),
    ("rollout", True), ("surgery", True)])
def test_pert_csv_matches_xai_tpu(tmp_path, params_path, name, batched):
    flags = ["--attr_func", name] + (BATCHED if batched
                                     else ["--image_count", "3"])
    ref = _pert(tmp_path, "jax", params_path, flags)
    got = _pert(tmp_path, "torch", params_path, flags)
    assert len(got) == 10
    _within(got, ref, 2e-3)


@pytest.mark.parametrize("name", NEAR_TIES)
@pytest.mark.parametrize("batched", [False, True])
def test_pert_csv_on_shared_maps(tmp_path, params_path, shared_maps, name,
                                 batched):
    flags = ["--attr_func", name] + (BATCHED if batched
                                     else ["--image_count", "3"])
    ref = _pert(tmp_path, "jax", params_path, flags)
    got = _pert(tmp_path, "torch", params_path, flags)
    _within(got, ref, 2e-3)


def test_pert_eclip_per_image_matches_without_sharing(tmp_path,
                                                      params_path):
    """eclip image by image happens to meet no reordered near-tie here:
    the port's own maps give xai_tpu's CSV."""
    flags = ["--attr_func", "eclip", "--image_count", "3"]
    _within(_pert(tmp_path, "torch", params_path, flags),
            _pert(tmp_path, "jax", params_path, flags), 2e-3)


@pytest.mark.parametrize("name", ["eclip", "game", "m2ib"])
def test_pert_bf16_runs_on_the_batched_path(tmp_path, params_path, name):
    """--attr_dtype bf16 under --image_batch (each name's maps are held to
    rho > 0.95 in test_torch_clip_methods.py): 10 finite scores; image by
    image the CLIP names ignore the dtype, as xai_tpu's do."""
    got = _pert(tmp_path, "torch", params_path,
                ["--attr_func", name, *BATCHED, "--attr_dtype", "bf16"])
    assert len(got) == 10 and all(np.isfinite(v) for v in got.values())
    one = ["--attr_func", name, "--image_count", "3"]
    assert _pert(tmp_path, "torch", params_path, one + ["--attr_dtype",
                                                        "bf16"]) == \
        _pert(tmp_path, "torch", params_path, one)


def _injected(path):
    """The port's randomize_family with xai_tpu's randomized weights: the
    text table rebuilt by the port's text tower, as its randomize_family
    rebuilds it."""
    def randomize(bundle, family, generator):
        module = copy.deepcopy(bundle.module)
        module.load_state_dict(load_params(path))
        return tclip.attach_text_table(bundle.with_module(module))
    return randomize


def _sanity(tmp_path, pkg, flags):
    d = tmp_path / f"{pkg}{len(os.listdir(tmp_path))}"
    mod = JS if pkg == "jax" else TS
    args = mod.build_parser().parse_args(
        ["--model", "CLIP16", *flags, "--output_dir", str(d)])
    if pkg == "jax":
        mod.evaluate_sanity(args)
    else:
        mod.evaluate_sanity(args, device="cpu")
    rows = _rows(d / "CLIP16" / f"{args.attr_func}_{args.image_count}"
                                f"_images.csv")
    del rows["Total Runtime"]
    return rows


@pytest.fixture(scope="module")
def clip48(tmp_path_factory):
    """The driver-sized tiny CLIP at 48 px (a 6 x 6 patch grid; HOG has
    one block), its params and xai_tpu's randomization of them (--seed 0:
    PRNGKey(1)), both through .npz."""
    with pytest.MonkeyPatch.context() as mp:
        _use(mp, dict(CLIP_DRIVER, img_hw=48))
        params = JC.build_bundle("CLIP16", seed=3).params
    d = tmp_path_factory.mktemp("clip48")
    path = save_params(params, str(d / "p.npz"))
    rand = save_params(JS.randomize_family(params, "clip",
                                           jax.random.PRNGKey(1)),
                       str(d / "r.npz"))
    return path, rand


@pytest.mark.parametrize("name,batch", [
    ("rollout", 1), ("surgery", 1), ("lrp", 2), ("maskclip", 2)])
def test_sanity_csv_matches_xai_tpu(tmp_path, monkeypatch, clip48, name,
                                    batch):
    """Three images; batched: one batch of two and a flushed tail; the
    randomized model's text table rebuilt in both packages."""
    path, rand = clip48
    _use(monkeypatch, dict(CLIP_DRIVER, img_hw=48))
    monkeypatch.setattr(TS, "randomize_family", _injected(rand))
    flags = ["--attr_func", name, "--synthetic", "3", "--image_count", "3",
             "--image_batch", str(batch), "--params_path", path]
    ref = _sanity(tmp_path, "jax", flags)
    assert all(np.isfinite(v) for v in ref.values()), ref
    _within(_sanity(tmp_path, "torch", flags), ref, 2e-3)


def test_sanity_runs_the_ports_randomization(tmp_path, params_path):
    """Without injection: the port's own CLIP randomization (its draws,
    xai_tpu's rule) and rebuilt table; finite SSIM, and SPR and HOG
    finite or NaN (32 px: HOG has no block)."""
    got = _sanity(tmp_path, "torch", [
        "--attr_func", "game", "--synthetic", "2", "--image_count", "2",
        "--image_batch", "2", "--params_path", params_path])
    assert list(got) == ["SSIM", "SPR", "HOG"] and np.isfinite(got["SSIM"])
    assert np.isfinite(got["SPR"])


def _seg(tmp_path, pkg, flags):
    d = tmp_path / f"{pkg}{len(os.listdir(tmp_path))}"
    mod = JG if pkg == "jax" else TG
    args = mod.build_parser().parse_args(
        ["--model", "CLIP16", *flags, "--output_dir", str(d)])
    if pkg == "jax":
        scores = mod.evaluate_imagenet_seg(args)
    else:
        scores = mod.evaluate_imagenet_seg(args, device="cpu")
    with open(d / "CLIP16" / f"{args.attr_func}_{args.image_count}"
                             f"_images") as f:
        assert len(f.read().splitlines()) == 4
    return scores


@pytest.mark.parametrize("name,batch", [
    ("eclip", 1), ("maskclip", 1), ("surgery", 1), ("eclip", 2),
    ("game", 2), ("rollout", 2)])
def test_seg_txt_matches_xai_tpu(tmp_path, params_path, name, batch):
    flags = ["--attr_func", name, "--synthetic", "3", "--image_batch",
             str(batch), "--params_path", params_path]
    _within(_seg(tmp_path, "torch", flags), _seg(tmp_path, "jax", flags),
            2e-3)


def test_image_finder_mask_matches_xai_tpu(tmp_path, params_path):
    """CLIP16 classifies by its prompt table in both packages' finders."""
    bundle = TC.build_bundle("CLIP16", params_path, device="cpu")
    xs = torch.stack([TC.normalize_input(it.trans_img, "clip", "cpu")
                      for it in ImageNetValStream("", 32, synthetic=6)])
    preds = TC.predict_classes(bundle, xs)
    gt = tmp_path / "gt.txt"
    gt.write_text("".join(f"{p if i % 2 == 0 else (p + 1) % 1000}\n"
                          for i, p in enumerate(preds)))
    flags = ["--model", "CLIP16", "--synthetic", "6", "--batch_size", "4",
             "--ground_truth", str(gt), "--params_path", params_path]
    ref = JF.find_correctly_classified(JF.build_parser().parse_args(
        flags + ["--class_maps_dir", str(tmp_path / "jax")]))
    got = TF.find_correctly_classified(TF.build_parser().parse_args(
        flags + ["--class_maps_dir", str(tmp_path / "torch")]),
        device="cpu")
    assert got.tolist() == ref.tolist() == [1, 0] * 3


def test_clip_panel_runs_every_name(params_path):
    """The 9-name CLIP panel: no name fails; each map is the registry's
    with the panel's generator, and within 1e-4 of xai_tpu's registry
    map for the names that draw nothing."""
    assert TQ.CLIP_PANEL == JQ.CLIP_PANEL
    bundle = TC.build_bundle("CLIP16", params_path, device="cpu")
    item = next(iter(ImageNetValStream("", 32, synthetic=1)))
    maps, failed = TQ.panel_maps(bundle, item, TQ.CLIP_PANEL, 3, "cpu")
    assert not failed and sorted(maps) == sorted(TQ.CLIP_PANEL)
    x = TC.normalize_input(item.trans_img, "clip", "cpu")
    target = TC.predict_classes(bundle, x[None])[0]
    jb = JC.build_bundle("CLIP16", params_path)
    for name, m in maps.items():
        ref = get_attribution("clip", name, TC.attr_context(bundle, {
            "x": x, "trans_img": item.trans_img, "target": target,
            "generator": TC.image_generator(3, item.index, "cpu")}))
        assert m.shape == (32, 32) and np.array_equal(m, ref), name
        if name == "m2ib":
            continue
        want = jax_attr("clip", name, JCtx(
            bundle=jb, x=jnp.asarray(x.numpy()), trans_img=item.trans_img,
            target=target, key=jax.random.PRNGKey(0), img_hw=32,
            extras=JC.clip_extras(jb, target)))
        np.testing.assert_allclose(m, want,
                                   atol=1e-4 * float(np.abs(want).max()))


def test_sweep_runs_clip_rows(tmp_path, monkeypatch, params_path):
    """The CLIP rows run in every driver (each named A11 before); the pert
    and seg rows' scores match xai_tpu's sweep on the same weights (each
    driver's bundle built from ``params_path``: the sweep takes no
    --params_path)."""
    from xai_tpu.runners import sweep as JW

    def same_weights(real):
        return lambda model, params_path_="", *a, **k: real(
            model, params_path_ or params_path, *a, **k)

    for mod in (JP, JG, TP, TS, TG):
        monkeypatch.setattr(mod, "build_bundle",
                            same_weights(mod.build_bundle))
    argv = ["--models", "CLIP16", "--methods", "game,rollout",
            "--synthetic", "1", "--image_count", "1"]
    records = TW.run_sweep(TW.build_parser().parse_args(
        argv + ["--drivers", "pert,sanity,seg", "--output_dir",
                str(tmp_path / "torch")]), device="cpu")
    assert [(r["driver"], r["attr_func"], r["status"]) for r in records] == [
        (d, m, "ok") for d in ("pert", "sanity", "seg")
        for m in ("game", "rollout")]
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
