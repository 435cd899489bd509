"""The lower-precision control (the reference with TF32 on, in the
program's place) fails each cell's limits at the cell's own size.  Needs
a CUDA card: ``python -m pytest portbench/tests -q -m card`` on one;
``portbench/calibrate.py`` reads the same numbers over many seeds."""
import pytest

from portbench import compare, harness
from portbench.entries.perturbation import control_records, \
    reference_records
from portbench.images import image_pool


@pytest.mark.card
@pytest.mark.parametrize("cell", ["r101_ig_b4", "vit16_rollout_b4",
                                  "r101_ig_b1"])
def test_control_fails_the_limits(card, cell):
    spec = harness.load_cell(cell)
    cfg, t = spec["cfg"], spec["traffic"]
    pool = image_pool(dict(t["images"], pool=4), cfg["img_hw"], 2 ** 31 + 3)
    ctl = control_records(cfg, t, 2 ** 31 + 3, card, pool, [0, 1, 2, 3])
    refs = reference_records(cfg, t, 2 ** 31 + 3, card, pool, ctl)
    correct, checks = compare.judge(compare.numbers(ctl, refs),
                                    spec["limits"])
    assert not correct, checks

