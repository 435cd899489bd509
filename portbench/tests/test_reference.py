"""The plain reference against the program on the CPU at small sizes:
TINY_R (one block a stage, 64 px) and a 32 px test ViT, on the
benchmark's seeded weights: forwards, IG and the batched IG, the
rollout, and the 10 battery scores of one map."""
import numpy as np
import pytest
import torch

from portbench.entries.perturbation import Reference, reference_family
from portbench.images import image_pool
from portbench.reference import battery
from portbench.weights import make_weights

from .helpers import HERE, load

SEED = 2 ** 32 + 17
CPU = torch.device("cpu")


def _setup(name, traffic):
    from xai_tpu_torch.runners.common import build_bundle, normalize_input
    cfg = load(HERE / "configs" / f"{name}.json")
    t = load(HERE.parent / "traffic" / f"{traffic}.json")
    bundle = build_bundle(cfg["program_model"], device=CPU)
    bundle.module.load_state_dict(make_weights(
        reference_family(cfg).param_spec(cfg), cfg["init"], SEED, CPU))
    imgs = image_pool(dict(t["images"], pool=3), cfg["img_hw"], SEED)
    xs = torch.stack([normalize_input(i, cfg["program_family"], CPU)
                      for i in imgs])
    return cfg, t, bundle, Reference(cfg, t, SEED, CPU), imgs, xs


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


def test_weights_are_the_seeds():
    cfg = load(HERE / "configs" / "tiny_r.json")
    spec = reference_family(cfg).param_spec(cfg)
    a = make_weights(spec, cfg["init"], SEED, CPU)
    b = make_weights(spec, cfg["init"], SEED, CPU)
    c = make_weights(spec, cfg["init"], SEED + 1, CPU)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["conv1.weight"], c["conv1.weight"])
    assert torch.all(a["layer1.0.bn3.scale"] == 0.2)


def test_image_pool_is_the_seeds():
    p = {"pool": 4, "coarse_grid": 8, "noise": 0.15}
    a, b = image_pool(p, 32, 5), image_pool(p, 32, 5)
    assert a.shape == (4, 32, 32, 3) and a.dtype == np.float32
    assert np.array_equal(a, b) and not np.array_equal(a, image_pool(p, 32, 6))
    assert a.min() >= 0 and a.max() <= 1
    assert len({x.tobytes() for x in a}) == 4


def test_reference_input_is_the_programs(tiny_vit):
    cfg, _, _, ref, imgs, xs = _setup("tiny_r", "ig_b4")
    assert torch.equal(ref.input(imgs[0]), xs[0].permute(2, 0, 1))


@pytest.mark.parametrize("name,traffic", [("tiny_r", "ig_b4"),
                                          ("tiny_vit", "rollout_b4")])
def test_forward(tiny_vit, name, traffic):
    cfg, _, bundle, ref, _, xs = _setup(name, traffic)
    x = xs.permute(0, 3, 1, 2).contiguous()
    with torch.no_grad():
        assert _rel(bundle.apply(x), ref.forward(x)) < 1e-5


def test_ig_single_and_batched():
    from xai_tpu_torch.methods.batch import ig_lig_batch
    from xai_tpu_torch.methods.gradient import ig, to_saliency
    cfg, _, bundle, ref, _, xs = _setup("tiny_r", "ig_b4")
    targets = [3, 500, 999]
    batched = ig_lig_batch(bundle, xs, torch.tensor(targets)).numpy()
    for i, t in enumerate(targets):
        want = ref.attribute(xs[i].permute(2, 0, 1), t)
        assert _rel(to_saliency(ig(bundle, xs[i], t)), want) < 1e-4
        assert _rel(batched[i], want) < 1e-4


def test_rollout(tiny_vit):
    from xai_tpu_torch.methods.batch import vit_saliency
    cfg, _, bundle, ref, _, xs = _setup("tiny_vit", "rollout_b4")
    got = vit_saliency("rollout", bundle, xs, [0] * 3, cfg["img_hw"])
    for i in range(3):
        assert _rel(got[i], ref.attribute(xs[i].permute(2, 0, 1), 0)) < 1e-5


@pytest.mark.parametrize("name,traffic", [("tiny_r", "ig_b1"),
                                          ("tiny_vit", "rollout_b4")])
def test_battery_scores(tiny_vit, name, traffic):
    from xai_tpu_torch.metrics.curves import run_battery
    from xai_tpu_torch.ops.blur import make_blur_fn
    cfg, t, bundle, ref, _, xs = _setup(name, traffic)
    rng = np.random.default_rng(0)
    for i in range(2):
        sal = rng.random((cfg["img_hw"],) * 2).astype(np.float32)
        with torch.no_grad():
            target = int(bundle.apply(xs[i:i + 1].permute(0, 3, 1, 2))
                         .argmax())
        got = run_battery(bundle.apply, xs[i], sal, make_blur_fn(31, 31.0),
                          chunk=45, target=target)
        want = ref.scores(xs[i].permute(2, 0, 1), sal, target)
        assert set(got) == set(want)
        for k in want:
            assert got[k] == pytest.approx(want[k], abs=1e-5), k


def test_flip_steps_follow_numpys_ties():
    """The reveal order of a map with many ties is the program's."""
    from xai_tpu_torch.metrics.curves import pixel_flip_steps
    sal = np.random.default_rng(1).integers(0, 5, (16, 16)).astype(
        np.float32)
    for desc in (True, False):
        assert np.array_equal(battery.flip_steps(sal, 16, desc),
                              pixel_flip_steps(sal, 16, desc))


def test_gaussian_kernel_is_the_published_one():
    from scipy.ndimage import gaussian_filter
    k = battery.gkern(31, 31.0)
    delta = np.zeros((31, 31))
    delta[15, 15] = 1
    assert np.array_equal(k, gaussian_filter(delta, 31.0).astype(np.float32))
