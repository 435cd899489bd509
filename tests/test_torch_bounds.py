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
