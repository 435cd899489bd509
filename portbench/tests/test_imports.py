"""No run loads JAX or the JAX package, and the reference loads nothing
of the program: each checked by whole top-level module names in a fresh
process (the program's name, ``xai_tpu_torch``, begins with the JAX
package's)."""
import subprocess
import sys

from portbench import harness


def _modules_after(code: str) -> set:
    p = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys\nprint(sorted({m.split("
         "'.')[0] for m in list(sys.modules)}))"],
        capture_output=True, text=True, cwd=harness.REPO, timeout=300)
    assert p.returncode == 0, p.stderr
    return set(eval(p.stdout.strip().splitlines()[-1]))


def test_reference_loads_nothing_of_the_program():
    top = _modules_after(
        "import portbench.reference, portbench.reference.resnet, "
        "portbench.reference.vit, portbench.reference.ig, "
        "portbench.reference.rollout, portbench.reference.battery")
    assert not top & {"xai_tpu_torch", "xai_tpu", "jax", "jaxlib", "flax"}


def test_a_run_loads_no_jax():
    """A whole run's modules, the program's among them, on the CPU."""
    top = _modules_after(
        "import time, torch\n"
        "from portbench import harness\n"
        "from portbench.tests.helpers import make_spec\n"
        "from xai_tpu_torch.models import vit\n"
        "vit.CONFIGS['vit_tiny_patch16_224'] = vit.ViTConfig(8, 32, 2, 2, "
        "4.0, 1000, 32)\n"
        "spec = make_spec('tiny_vit', 'rollout_b4', 'vit16_rollout_b4')\n"
        "out = harness.measure(spec, 5, 0.0, False, [torch.device('cpu')], "
        "time.perf_counter())\n"
        "assert out['correct'], out\n"
        "assert harness.forbidden_modules() == []")
    assert "xai_tpu_torch" in top
    assert not top & set(harness.FORBIDDEN)


def test_forbidden_names_are_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "xai_tpu_torch_extra", sys)
    assert "xai_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "xai_tpu.methods", sys)
    assert "xai_tpu" in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax", sys)
    assert "jax" in harness.forbidden_modules()
