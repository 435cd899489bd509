"""Fixtures of the benchmark's own tests.  Run them from the root of the
repository: ``python -m pytest portbench/tests -q``; the tests marked
``card`` need an NVIDIA card and skip without one (on a card machine:
``python -m pytest portbench/tests -q -m card``)."""
import pytest
import torch

from .helpers import HERE, load


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips on a machine without one")


@pytest.fixture(autouse=True)
def _few_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


@pytest.fixture
def card():
    """The first CUDA card, or a skip."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.fixture
def tiny_vit(monkeypatch):
    """The program's TINY_VIT at the size of ``configs/tiny_vit.json``."""
    from xai_tpu_torch.models import vit
    cfg = load(HERE / "configs" / "tiny_vit.json")
    monkeypatch.setitem(vit.CONFIGS, "vit_tiny_patch16_224", vit.ViTConfig(
        cfg["patch"], cfg["hidden_size"], cfg["num_hidden_layers"],
        cfg["num_attention_heads"], cfg["mlp_size"] / cfg["hidden_size"],
        cfg["num_classes"], cfg["img_hw"]))
    return cfg
