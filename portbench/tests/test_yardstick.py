"""The benchmark's FLOP and byte counts against hand-worked shapes, and
the frozen copy of the device-interval union."""
import pytest

from portbench import yardstick as Y
from portbench.reference import resnet, vit

from .helpers import HERE, load


def test_resnet_stem_and_head_macs():
    # no blocks: the 7x7/2 stem on 224 px (112 x 112 x 64 outputs of 3 x
    # 49 MACs) and the 2048 x 1000 head
    cfg = dict(load(HERE.parent / "configs" / "r101.json"), layers=[0] * 4)
    assert resnet.macs(cfg) == 112 * 112 * 64 * 147 + 2048 * 1000


def test_resnet_one_block_macs():
    # stem 32 x 32 x 64 x 147 at 64 px, max-pool to 16; one bottleneck
    # 64 -> 64 -> 256 at 16 x 16 with its 1x1 downsample
    cfg = dict(load(HERE / "configs" / "tiny_r.json"), layers=[1, 0, 0, 0])
    block = 256 * (64 * 64 + 64 * 64 * 9 + 256 * 64 + 256 * 64)
    assert resnet.macs(cfg) == 32 * 32 * 64 * 147 + block + 2048 * 1000


def test_vit_macs_hand_worked():
    cfg = load(HERE / "configs" / "tiny_vit.json")
    t, d, m = 17, 32, 128
    block = t * 3 * d * d + 2 * t * t * d + t * d * d + 2 * t * d * m
    assert block == 227392
    assert vit.macs(cfg) == 16 * d * 3 * 64 + 2 * block + 1000 * d


@pytest.mark.parametrize("name,module,gmac", [("r101", resnet, 7.8),
                                              ("vit_b16", vit, 17.6)])
def test_published_macs(name, module, gmac):
    cfg = load(HERE.parent / "configs" / f"{name}.json")
    assert module.macs(cfg) / 1e9 == pytest.approx(gmac, rel=5e-3)


@pytest.mark.parametrize("traffic,forwards", [("ig_b4", 776),
                                              ("rollout_b4", 677),
                                              ("ig_b1", 776)])
def test_forwards_per_image(traffic, forwards):
    t = load(HERE.parent / "traffic" / f"{traffic}.json")
    # target forward + attribution + 3 passes of 225 points
    assert Y.forwards_per_image(t, 224) == forwards


def test_flops_per_image():
    r101 = resnet.macs(load(HERE.parent / "configs" / "r101.json"))
    ig = load(HERE.parent / "traffic" / "ig_b4.json")
    assert Y.flops_per_image(r101, ig, 224) / 1e12 == pytest.approx(
        12.108, abs=1e-3)
    vitb = vit.macs(load(HERE.parent / "configs" / "vit_b16.json"))
    ro = load(HERE.parent / "traffic" / "rollout_b4.json")
    assert Y.flops_per_image(vitb, ro, 224) / 1e12 == pytest.approx(
        23.781, abs=1e-3)


def test_reveal_bound():
    # one [4, 45, 3, 224, 224] chunk: 4 x (45 + 2) planes of 3 x 224 x
    # 224 float32 and 4 flip maps, plus 45 int32 steps
    nbytes = 4 * (45 * 150528 + 2 * 150528 + 50176) * 4 + 45 * 4
    assert nbytes == 114000052
    assert Y.reveal_bound_s(45, 3, 224, 224, 4) == nbytes / 3.35e12
    assert Y.battery_points(224) == 225
    # 3 passes of 5 chunks of 45
    assert Y.reveal_bound_per_step_s(224, 4, 45) == pytest.approx(
        15 * nbytes / 3.35e12)
    # a ragged last chunk: 33 points at 32 px in chunks of 20
    assert Y.reveal_bound_per_step_s(32, 1, 20) == pytest.approx(
        3 * (Y.reveal_bound_s(20, 3, 32, 32) + Y.reveal_bound_s(
            13, 3, 32, 32)))


@pytest.mark.parametrize("intervals,busy", [
    ([], 0.0),
    ([(0, 10)], 10.0),
    ([(0, 10), (20, 25)], 15.0),
    ([(0, 10), (5, 15)], 15.0),
    ([(0, 20), (5, 10)], 20.0),
    ([(20, 25), (0, 10), (10, 12)], 17.0),
])
def test_busy_union(intervals, busy):
    assert Y.busy_us(intervals) == busy


@pytest.mark.parametrize("name,peak", [("float32", 67e12), ("f32", 67e12),
                                       ("bfloat16", 989.4e12),
                                       ("bf16", 989.4e12), ("tf32", 494.7e12),
                                       ("float8", 1978.9e12)])
def test_peak_by_precision(name, peak):
    assert Y.peak_flops_per_s(name) == peak


def test_least_seconds_float32_is_flops_over_peak():
    r101 = resnet.macs(load(HERE.parent / "configs" / "r101.json"))
    ig = load(HERE.parent / "traffic" / "ig_b4.json")
    assert Y.least_s_per_image(r101, ig, 224, "float32") == pytest.approx(
        Y.flops_per_image(r101, ig, 224) / 67e12)


def test_least_seconds_of_a_mixed_step():
    # a bf16 attribution of 100 forward-equivalents beside an f32 target
    # forward and battery of 3 x 225
    ig = dict(load(HERE.parent / "traffic" / "ig_b4.json"),
              attr_dtype="bf16")
    assert Y.least_s_per_image(10, ig, 224, "float32") == pytest.approx(
        20 * 100 / 989.4e12 + 20 * 676 / 67e12)
