"""TIS, VIT_CX, MDA and MDA_dense through the drivers of xai_tpu_torch,
and the older ViT seg driver ``runners/imagenet_seg_eval.py``, against
xai_tpu's drivers on the CPU.

``--model TINY_VIT`` is xai_tpu's 32 px test ViT in both packages
(``test_torch_vit_drivers.py``), or, for TIS, the same ViT at 4 blocks of
256 (``CFG_TIS``: TIS's 1024 masks need 1024 activation rows).  The
randomness the two packages cannot share is injected into both:
ViT-CX's noise and Shapley sampling's permutations.  CSVs and TXTs must
be within 2e-3 of xai_tpu's.
"""
import os

import numpy as np
import pytest

from xai_tpu.models import vit as jvit
from xai_tpu.runners.common import build_bundle as jax_build_bundle
from xai_tpu.runners.common import save_params

from xai_tpu_torch.models import vit as tvit

from test_torch_vit import CFG32
from test_torch_vit_drivers import (  # noqa: F401 (fixtures)
    _pert, _seg, _within, jax_params, params_path, shared_vit_cx_noise,
    tis_vit, vit32)
from torch_one_thread import one_torch_thread  # noqa: F401 (autouse)

SLICE2 = ["TIS", "VIT_CX", "MDA", "MDA_dense"]


@pytest.mark.parametrize("name", SLICE2)
def test_slice2_pert_csv_matches_xai_tpu(tmp_path, params_path, tis_vit,
                                         shared_vit_cx_noise, name):
    path = tis_vit if name == "TIS" else params_path
    if name != "TIS":           # the 32 px test ViT
        jvit.CONFIGS["vit_tiny_patch16_224"] = jvit.ViTConfig(**CFG32)
        tvit.CONFIGS["vit_tiny_patch16_224"] = tvit.ViTConfig(**CFG32)
    flags = ["--attr_func", name, "--image_count", "3"]
    ref = _pert(tmp_path, "jax", path, flags)
    got = _pert(tmp_path, "torch", path, flags)
    assert len(got) == 10
    _within(got, ref, 2e-3)


@pytest.mark.parametrize("name", SLICE2)
def test_slice2_seg_txt_matches_xai_tpu(tmp_path, params_path, tis_vit,
                                        shared_vit_cx_noise, name):
    path = tis_vit if name == "TIS" else params_path
    if name != "TIS":
        jvit.CONFIGS["vit_tiny_patch16_224"] = jvit.ViTConfig(**CFG32)
        tvit.CONFIGS["vit_tiny_patch16_224"] = tvit.ViTConfig(**CFG32)
    flags = ["--attr_func", name, "--synthetic", "2", "--params_path", path]
    _within(_seg(tmp_path, "torch", flags), _seg(tmp_path, "jax", flags),
            2e-3)


# --- the older ViT seg driver, imagenet_seg_eval ---

def _seg_eval(tmp_path, pkg, flags):
    from xai_tpu.runners import imagenet_seg_eval as JE
    from xai_tpu_torch.runners import imagenet_seg_eval as TE

    d = tmp_path / f"{pkg}{len(os.listdir(tmp_path))}"
    mod = JE if pkg == "jax" else TE
    args = mod.build_parser().parse_args(
        ["--model", "TINY_VIT", "--synthetic", "2", "--acc_cutoff", "0",
         *flags, "--output_dir", str(d)])
    scores = mod.run(args) if pkg == "jax" else mod.run(args, device="cpu")
    with open(d / f"TINY_VIT_{args.method}.txt") as f:
        assert len(f.read().splitlines()) == 4
    return scores


@pytest.fixture()
def shared_perms(monkeypatch):
    """Shapley sampling's permutations, injected into both packages: the
    k-th image draws numpy's RandomState(k)."""
    from xai_tpu.methods import ablation as JA
    from xai_tpu_torch.methods import ablation as TA

    def inject(real, count):
        def wrapped(bundle, x, target, key, num_patches=14, n_samples=25,
                    **kw):
            count.append(None)
            rs = np.random.RandomState(len(count))
            perms = np.stack([rs.permutation(num_patches ** 2)
                              for _ in range(n_samples)])
            return real(bundle, x, target, key, num_patches, n_samples,
                        perms=perms, **kw)
        return wrapped

    monkeypatch.setattr(JA, "shapley_sampling",
                        inject(JA.shapley_sampling, []))
    monkeypatch.setattr(TA, "shapley_sampling",
                        inject(TA.shapley_sampling, []))


@pytest.mark.parametrize("method,flags", [
    ("rollout", []), ("rollout", ["--thr", "0.4"]),
    ("shap", ["--shap_samples", "2"]),
    ("Calibrate_Best_Possible", ["--epochs", "2"]), ("MDA_dense", [])],
    ids=["rollout", "rollout_thr", "shap", "calibrate", "MDA_dense"])
def test_imagenet_seg_eval_txt_matches_xai_tpu(tmp_path, monkeypatch,
                                               params_path, shared_perms,
                                               method, flags):
    """--acc_cutoff 0: random weights are never 60 % confident.  shap
    runs over the driver's 14 x 14 patch grid, which needs an image side
    that 14 divides (xai_tpu's patch mask): the test ViT at 56 px."""
    path = params_path
    if method == "shap":
        cfg56 = jvit.ViTConfig(**dict(CFG32, img_hw=56))
        monkeypatch.setitem(jvit.CONFIGS, "vit_tiny_patch16_224", cfg56)
        monkeypatch.setitem(tvit.CONFIGS, "vit_tiny_patch16_224",
                            tvit.ViTConfig(**dict(CFG32, img_hw=56)))
        path = save_params(jax_build_bundle("TINY_VIT", seed=2).params,
                           str(tmp_path / "vit56.npz"))
    out = tmp_path / "runs"
    out.mkdir()
    flags = ["--method", method, "--params_path", path, *flags]
    _within(_seg_eval(out, "torch", flags), _seg_eval(out, "jax", flags),
            2e-3)


def test_imagenet_seg_eval_refuses_shard_images(tmp_path, params_path):
    """--shard_images, which raised naming ROADMAP item A14, is the plain
    run without a process group: the same scores and the same TXT
    (tests/test_torch_multi_process.py runs it over two processes)."""
    out = tmp_path / "runs"
    out.mkdir()
    flags = ["--method", "rollout", "--params_path", params_path]
    plain = _seg_eval(out, "torch", flags)
    assert _seg_eval(out, "torch", flags + ["--shard_images"]) == plain
    texts = [(out / d / "TINY_VIT_rollout.txt").read_text()
             for d in ("torch0", "torch1")]
    assert texts[0] == texts[1]
