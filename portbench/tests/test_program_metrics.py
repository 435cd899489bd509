"""The readers of the program's spans and counters (``prep_s_per_image``,
``battery_host_s_per_image``, ``battery_host_idle_pct``,
``model_rows_per_image``) on a synthetic window and synthetic spans."""
import sys

import pytest

import xai_tpu_torch.utils
from portbench.metrics import (battery_host_idle_pct,
                               battery_host_s_per_image,
                               model_rows_per_image, prep_s_per_image)
from xai_tpu_torch.utils import trace

READERS = (prep_s_per_image, battery_host_s_per_image,
           battery_host_idle_pct, model_rows_per_image)


def _span(i, parent, name, s, e, rows=(0, 0)):
    return trace.Span(i, parent, name, "MainThread", None, s, e,
                      {"model_rows": rows[0]}, {"model_rows": rows[1]})


# one image-by-image step in [100, 1000), and spans on either side of it
STEP = [
    _span(1, None, "normalize_input", 100, 110),
    _span(2, None, "image_gates", 110, 150, (0, 1)),
    _span(3, None, "attribution", 150, 400, (1, 51)),
    _span(4, None, "battery", 400, 1000, (51, 726)),
    _span(5, 4, "battery.schedule", 400, 450, (51, 51)),
    _span(6, 4, "battery.read", 450, 900, (726, 726)),
    _span(7, 4, "battery.score", 900, 1000, (726, 726)),
]
OUTSIDE = [_span(8, None, "normalize_input", 5, 10),
           _span(9, None, "image_gates", 1000, 1100, (726, 727))]
# card 0 idle in [140, 160), [420, 430) and [890, 960): 10 + 60 ns of it
# under the host scoring; card 1 never idle
EVENTS = [(0, 100, 140, "k"), (0, 160, 420, "k"), (0, 430, 890, "k"),
          (0, 880, 890, "k"), (0, 960, 1000, "k"), (1, 100, 1000, "k")]


def _ctx(cards=1, traced=True, images=1):
    return {"lo_ns": 100, "hi_ns": 1000, "window_s": 900e-9,
            "images": images, "cards": cards, "traced": traced,
            "events": [e for e in EVENTS if e[0] < cards]}


@pytest.fixture
def records(monkeypatch):
    monkeypatch.setattr(trace, "_RECORDS", STEP + OUTSIDE)


def test_prep_and_host_scoring_seconds(records):
    assert prep_s_per_image.read(_ctx()) == pytest.approx(50e-9)
    assert battery_host_s_per_image.read(_ctx()) == pytest.approx(150e-9)
    assert prep_s_per_image.read(_ctx(images=2)) == pytest.approx(25e-9)


def test_host_idle_share_is_averaged_over_cards(records):
    assert battery_host_idle_pct.read(_ctx()) == pytest.approx(
        100 * 70 / 900)
    assert battery_host_idle_pct.read(_ctx(cards=2)) == pytest.approx(
        100 * 35 / 900)
    assert battery_host_idle_pct.read(_ctx(traced=False)) is None


def test_model_rows_over_top_level_spans(records):
    """The children's counts are inside their parent's, and spans outside
    the window (the set-up, a later step) are not counted."""
    assert model_rows_per_image.read(_ctx()) == 1 + 50 + 675


@pytest.mark.parametrize("reader", READERS, ids=lambda r: r.__name__)
def test_no_spans_read_nothing(reader, monkeypatch):
    monkeypatch.setattr(trace, "_RECORDS", OUTSIDE)
    assert reader.read(_ctx()) is None


@pytest.mark.parametrize("reader", READERS, ids=lambda r: r.__name__)
def test_a_program_without_spans_reads_nothing(reader, records, monkeypatch):
    """A program without the trace module (the parent's): its import
    fails, and the reader reads nothing though spans lie in the window."""
    assert reader.read(_ctx()) is not None
    monkeypatch.delattr(xai_tpu_torch.utils, "trace")
    monkeypatch.setitem(sys.modules, "xai_tpu_torch.utils.trace", None)
    with pytest.raises(ImportError):
        from xai_tpu_torch.utils import trace as _  # noqa: F401
    assert reader.read(_ctx()) is None
