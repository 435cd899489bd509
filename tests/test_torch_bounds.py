"""The kernels' bounds (xai_tpu_torch/kernels/bounds.py), held on the CPU.

``chip_smoke.py`` prints each kernel's time on the card beside the least
time the card could take for the same work; these tests hold the counts
behind those bounds at the main paths' shapes.
"""
import pytest

from xai_tpu_torch.kernels import bounds as kb


def test_window_span_counts_in_image_offsets():
    # brute force: every (position, offset) pair that stays on the axis
    for n, r in [(1, 0), (5, 2), (7, 12), (30, 4)]:
        want = sum(1 for i in range(n) for d in range(-r, r + 1)
                   if 0 <= i + d < n)
        assert kb.window_span(n, r) == want


def test_quickshift_pairs_at_224_px():
    # LIME's w = wd = 12 at 224 px: 5444 in-axis offsets an axis
    dens, parent = kb.quickshift_pairs(1, 224, 224, 12, 12)
    assert kb.window_span(224, 12) == 5444
    assert dens == 5444 ** 2 == 29_637_136          # 29.64 M
    assert parent == 5444 ** 2 - 224 * 224 == 29_586_960   # 29.59 M


def test_quickshift_and_blur_bounds_at_the_main_paths_shapes():
    ms, ops = kb.quickshift_bound_ms(1, 224, 224, 12, 12)
    assert ops == 12 * 29_637_136 + 14 * 29_586_960
    assert ms * 1e3 == pytest.approx(22.98, abs=5e-3)      # operations
    assert kb.quickshift_exp_ms(1, 224, 224, 12) * 1e3 == pytest.approx(
        7.09, abs=5e-3)
    ms, by = kb.blur_bound_ms(3, 224, 224, 31)
    assert by == "bytes" and ms * 1e3 == pytest.approx(0.359, abs=5e-4)
    assert kb.reveal_bound_ms(45, 3, 224, 224) * 1e3 == pytest.approx(
        8.508, abs=5e-4)


@pytest.mark.parametrize("batch", [2, 4, 12])
def test_bounds_scale_linearly_in_the_batch(batch):
    one, ops_one = kb.quickshift_bound_ms(1, 224, 224, 12, 12)
    many, ops_many = kb.quickshift_bound_ms(batch, 224, 224, 12, 12)
    assert ops_many == batch * ops_one
    assert many == pytest.approx(batch * one, rel=1e-12)
    assert kb.quickshift_pairs(batch, 224, 224, 12, 12) == tuple(
        batch * p for p in kb.quickshift_pairs(1, 224, 224, 12, 12))
    assert kb.blur_bound_ms(batch * 3, 224, 224, 31)[0] == pytest.approx(
        batch * kb.blur_bound_ms(3, 224, 224, 31)[0], rel=1e-12)
    # at four images the quickshift bound is 91.92 us
    if batch == 4:
        assert many * 1e3 == pytest.approx(91.92, abs=5e-3)


def test_batched_reveal_bound():
    """Four images of a 45-step chunk at 224 px: 114.0 MB, 34.03 us at
    3.35 TB/s, the same 8.5 us an image as one image's chunk."""
    one = kb.reveal_bound_ms(45, 3, 224, 224)
    assert kb.reveal_bound_ms(45, 3, 224, 224, b=1) == one
    four = kb.reveal_bound_ms(45, 3, 224, 224, b=4)
    nbytes = 4 * (45 + 2) * 3 * 224 * 224 * 4 + 4 * 224 * 224 * 4 + 45 * 4
    assert nbytes == 114_000_052
    assert four == pytest.approx(nbytes / kb.HBM_BYTES_PER_S * 1e3,
                                 rel=1e-12)
    assert four * 1e3 == pytest.approx(34.030, abs=5e-4)
    # the steps are read once for all images, not once an image
    assert four == pytest.approx(4 * one - 3 * 45 * 4 /
                                 kb.HBM_BYTES_PER_S * 1e3, rel=1e-12)


def test_bn_act_bound_counts_each_byte_once():
    """The epilogue of the stem at the battery's 180 rows: 578.0 MB read
    and as much written, 345.09 us at 3.35 TB/s; a residual adds a third
    pass of bytes, a residual BN two more channel vectors."""
    stem = 180 * 64 * 112 * 112 * 4
    assert kb.bn_act_bound_ms(180, 64, 112, 112) == pytest.approx(
        (2 * stem + 2 * 64 * 4) / kb.HBM_BYTES_PER_S * 1e3, rel=1e-12)
    assert kb.bn_act_bound_ms(180, 64, 112, 112) * 1e3 == pytest.approx(
        345.09, abs=5e-3)
    one = 180 * 2048 * 7 * 7 * 4
    assert kb.bn_act_bound_ms(180, 2048, 7, 7, residual=True) == (
        pytest.approx((3 * one + 2 * 2048 * 4) / kb.HBM_BYTES_PER_S * 1e3))
    assert kb.bn_act_bound_ms(180, 2048, 7, 7, True, True) == pytest.approx(
        (3 * one + 4 * 2048 * 4) / kb.HBM_BYTES_PER_S * 1e3)



def test_layernorm_bound_counts_each_byte_once():
    """ViT-B/16's LayerNorm over a 180-row forward's 35,460 token rows:
    109.0 MB read and as much written, 65.04 us at 3.35 TB/s; Swin-B's
    first stage, 564,480 rows of 128, 172.55 us."""
    vit = 180 * 197 * 768 * 4
    assert kb.layernorm_bound_ms(180 * 197, 768) == pytest.approx(
        (2 * vit + 2 * 768 * 4) / kb.HBM_BYTES_PER_S * 1e3, rel=1e-12)
    assert kb.layernorm_bound_ms(180 * 197, 768) * 1e3 == pytest.approx(
        65.037, abs=5e-3)
    assert kb.layernorm_bound_ms(180 * 3136, 128) * 1e3 == pytest.approx(
        172.546, abs=5e-3)
