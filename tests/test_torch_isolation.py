"""xai_tpu_torch stands alone: it imports neither jax nor xai_tpu, and its
entry points never fall back to the CPU on their own.

The imports are checked in a subprocess, because this test process has
already imported jax (conftest.py).
"""
import os
import shutil
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_ALL = r"""
import importlib, pkgutil, sys
import xai_tpu_torch
names = [m.name for m in pkgutil.walk_packages(xai_tpu_torch.__path__,
                                               "xai_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = sorted(k for k in sys.modules
             if k.split(".")[0] in ("jax", "jaxlib", "flax", "xai_tpu"))
assert not bad, bad
for m in ("runners.evaluate_perturbation", "ops.resize", "methods.guided",
          "methods.ablation", "methods.rise", "methods.adversarial",
          "methods.agi", "methods.gig", "methods.xrai", "native",
          "metrics.sanity", "metrics.seg", "data.segmentation", "data.voc",
          "runners.evaluate_sanity", "runners.evaluate_imagenet_seg",
          "runners.image_finder", "runners.qualitative_generation",
          "runners.sweep", "utils.visualization", "utils.render",
          "utils.saver", "models.vit", "methods.vit_explain",
          "methods.vit_lrp", "models.clip", "data.tokenizer",
          "methods.clip_explain", "methods.clip_surgery",
          "methods.clip_m2ib", "models.vgg", "models.inception",
          "models.convnext", "models.swin", "models.pvt", "models.maxvit",
          "convert.torch_import", "convert.cli", "parallel.multi_host",
          "parallel.mesh", "parallel.sharded_eval", "examples.common",
          "examples.cnn_example", "examples.vit_example",
          "examples.clip_example"):
    assert "xai_tpu_torch." + m in names, (m, names)
# the native segmenter compiles the port's own copy of its source
import xai_tpu_torch.native as native
assert native.SOURCE.parent == native.HERE
assert native.HERE.parent.name == "xai_tpu_torch", native.HERE
print(len(names))
"""


# the packages the card's machine need not have: blocked, every port
# module still imports, and none of them is imported on the way
_IMPORT_WITHOUT = r"""
import importlib, pkgutil, sys
BLOCKED = ("sklearn", "h5py", "matplotlib")
for name in BLOCKED:
    sys.modules[name] = None
import xai_tpu_torch
for m in pkgutil.walk_packages(xai_tpu_torch.__path__, "xai_tpu_torch."):
    importlib.import_module(m.name)
import chip_smoke
assert all(sys.modules[name] is None for name in BLOCKED)
print("ok")
"""


# every file the CLIP path opens while it tokenizes the 1000 prompts and
# reads the class names: the port's own copies, nothing of xai_tpu/
_OWN_DATA = r"""
import os, sys
opened = []
sys.addaudithook(lambda event, args: event == "open" and isinstance(
    args[0], str) and opened.append(os.path.abspath(args[0])))
from xai_tpu_torch.data import tokenizer
from xai_tpu_torch.models.clip import class_prompt_tokens
ids = class_prompt_tokens()
names = tokenizer.imagenet_class_names()
assert ids.shape == (1000, 77) and len(names) == 1000
data = [p for p in opened if p.startswith(os.getcwd() + os.sep)
        and p.endswith((".txt", ".gz"))]
here = os.path.join(os.getcwd(), "xai_tpu_torch", "data")
assert sorted(set(data)) == sorted(
    os.path.join(here, f) for f in ("bpe_simple_vocab_16e6.txt.gz",
                                    "imagenet_classes.txt")), data
bad = [p for p in opened
       if os.path.join(os.getcwd(), "xai_tpu") + os.sep in p]
assert not bad, bad
print("ok")
"""


def _run(args, cwd, timeout=120):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=timeout)


def test_port_imports_no_jax_and_no_xai_tpu():
    r = _run(["-c", _IMPORT_ALL], REPO)
    assert r.returncode == 0, r.stderr
    assert int(r.stdout.strip()) >= 64        # every module was imported


def test_port_reads_its_own_data_files():
    """The tokenizer and the class names come from the port's copies
    under xai_tpu_torch/data/; no file under xai_tpu/ is opened."""
    r = _run(["-c", _OWN_DATA], REPO)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "ok"


def test_port_imports_without_sklearn_h5py_matplotlib():
    r = _run(["-c", _IMPORT_WITHOUT], REPO)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "ok"


def test_entry_points_raise_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this checks the behaviour on a machine without CUDA")
    from xai_tpu_torch.runners import evaluate_perturbation as TD
    from xai_tpu_torch.runners.common import build_bundle

    with pytest.raises(RuntimeError, match="CUDA"):
        build_bundle("TINY_R")
    args = TD.build_parser().parse_args(
        ["--model", "TINY_R", "--synthetic", "1", "--image_count", "1",
         "--output_dir", str(tmp_path)])
    with pytest.raises(RuntimeError, match="CUDA"):
        TD.evaluate_perturbation(args)
    assert not os.listdir(tmp_path)


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_chip_smoke_fails_without_gpu_or_package(tmp_path, where):
    """chip_smoke.py exits non-zero and prints no result line when there is
    no GPU, and when it stands in a directory without the package."""
    if where == "repo":
        if torch.cuda.is_available():
            pytest.skip("this checks the behaviour on a machine without CUDA")
        cwd = REPO
    else:
        cwd = str(tmp_path)
        shutil.copy(os.path.join(REPO, "chip_smoke.py"), cwd)
    r = _run(["chip_smoke.py"], cwd)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
