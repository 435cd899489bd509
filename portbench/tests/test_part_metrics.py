"""The readers of the program's part spans (the seven
``<kind>_device_s_per_image`` and ``parts_window_pct``) on synthetic
``Span`` records, served by a stand-in for the program's
``trace.records``: each sums the ``device_s`` of its own kind's spans that
start in the window, over the images scored; the share of the window
stays at or under 100 where the parts do not overlap; and each reads
nothing without part spans, without ``device_s`` (spans of a CPU run),
from a program whose ``trace.records`` takes no ``parts`` (one without
part spans), or from a program without the trace module."""
import sys

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import xai_tpu_torch.utils
from portbench.metrics import (attn_device_s_per_image,
                               backward_device_s_per_image,
                               conv_device_s_per_image,
                               layout_device_s_per_image,
                               linear_device_s_per_image,
                               norm_device_s_per_image, parts_window_pct,
                               pointwise_device_s_per_image)
from xai_tpu_torch.utils import trace

READERS = {"linear": linear_device_s_per_image,
           "conv": conv_device_s_per_image,
           "attn": attn_device_s_per_image,
           "norm": norm_device_s_per_image,
           "pointwise": pointwise_device_s_per_image,
           "layout": layout_device_s_per_image,
           "backward": backward_device_s_per_image}


def _part(i, kind, s, e, device_s):
    return trace.Span(i, 1, f"part.{kind}", "MainThread", "cuda:0", s, e,
                      {}, {}, device_s)


def _ctx(images=2, window_s=1.0, cards=1):
    return {"lo_ns": 100, "hi_ns": 1000, "images": images,
            "window_s": window_s, "cards": cards}


def _program(monkeypatch, part_spans, spans=()):
    """The program's ``trace.records`` over these part spans and other
    spans, by start, in a window."""
    def records(lo_ns=None, hi_ns=None, parts=False):
        return sorted((s for s in (part_spans if parts else spans)
                       if (lo_ns is None or s.start_ns >= lo_ns)
                       and (hi_ns is None or s.start_ns < hi_ns)),
                      key=lambda s: s.start_ns)
    monkeypatch.setattr(trace, "records", records)


# in the window [100, 1000): one part of each kind, linear twice; outside
# it, a linear part before and a conv part at its end
KINDS = tuple(READERS)
INSIDE = ([_part(2 + i, k, 100 + 100 * i, 190 + 100 * i, 0.01 * (i + 1))
           for i, k in enumerate(KINDS)]
          + [_part(20, "linear", 900, 990, 0.5)])
OUTSIDE = [_part(21, "linear", 10, 90, 7.0),
           _part(22, "conv", 1000, 1010, 7.0)]


@pytest.fixture
def parts(monkeypatch):
    _program(monkeypatch, INSIDE + OUTSIDE)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("images", [1, 2])
def test_each_reader_sums_its_own_kind_over_images(parts, kind, images):
    i = KINDS.index(kind)
    want = 0.01 * (i + 1) + (0.5 if kind == "linear" else 0.0)
    assert READERS[kind].read(_ctx(images)) == pytest.approx(want / images)


def test_window_share_sums_every_kind_over_cards(parts):
    total = sum(0.01 * (i + 1) for i in range(len(KINDS))) + 0.5
    assert parts_window_pct.read(_ctx()) == pytest.approx(100 * total)
    assert parts_window_pct.read(_ctx(cards=2)) == pytest.approx(
        50 * total)


def test_window_share_of_leaves_stays_under_100(monkeypatch):
    """Parts that tile the window without overlap, each timed at its
    host length, read 100 at most."""
    tiles = [_part(2 + i, KINDS[i % len(KINDS)], 100 + 90 * i,
                   190 + 90 * i, 90e-9) for i in range(10)]
    _program(monkeypatch, tiles)
    assert parts_window_pct.read(_ctx(window_s=900e-9)) == \
        pytest.approx(100.0)
    assert parts_window_pct.read(_ctx(window_s=1000e-9)) <= 100.0


def test_nothing_read_without_parts_or_device_seconds(monkeypatch):
    _program(monkeypatch, [], [trace.Span(
        1, None, "battery", "MainThread", None, 100, 900, {}, {})])
    assert all(r.read(_ctx()) is None for r in READERS.values())
    assert parts_window_pct.read(_ctx()) is None
    _program(monkeypatch, [s._replace(card="cpu", device_s=None)
                           for s in INSIDE])
    assert all(r.read(_ctx()) is None for r in READERS.values())
    assert parts_window_pct.read(_ctx()) is None


def test_a_missing_kind_reads_nothing(monkeypatch):
    """A model without attention (R101) reads no ``attn`` seconds."""
    _program(monkeypatch, [s for s in INSIDE if s.name != "part.attn"])
    assert attn_device_s_per_image.read(_ctx()) is None
    assert linear_device_s_per_image.read(_ctx()) is not None


def test_the_programs_own_records_serve_the_readers():
    """The program's ``records(parts=True)`` after a CPU run under a
    profiler: a part span without ``device_s``, so nothing to read."""
    trace.clear()
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            with trace.part("linear", torch.zeros(1)):
                pass
        (only,) = trace.records(parts=True)
        assert only.name == "part.linear" and only.device_s is None
        ctx = dict(_ctx(), lo_ns=only.start_ns, hi_ns=only.start_ns + 1)
        assert linear_device_s_per_image.read(ctx) is None
        assert parts_window_pct.read(ctx) is None
    finally:
        trace.clear()


def test_nothing_read_from_a_program_without_part_spans(monkeypatch,
                                                        parts):
    """A program whose ``records`` takes no ``parts`` (one from before
    part spans) or that lacks the trace module reads nothing, and raises
    nothing."""
    def older(lo_ns=None, hi_ns=None):
        return []
    monkeypatch.setattr(trace, "records", older)
    assert all(r.read(_ctx()) is None for r in READERS.values())
    assert parts_window_pct.read(_ctx()) is None
    _program(monkeypatch, INSIDE)
    assert parts_window_pct.read(_ctx()) is not None
    monkeypatch.delattr(xai_tpu_torch.utils, "trace")
    monkeypatch.setitem(sys.modules, "xai_tpu_torch.utils.trace", None)
    assert all(r.read(_ctx()) is None for r in READERS.values())
    assert parts_window_pct.read(_ctx()) is None
