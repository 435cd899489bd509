"""Spans, the clipping of device events to the window, the busy share
per card and the breakdown of idle time by the open span."""
import pytest

from portbench import trace


def _spans(records):
    s = trace.Spans()
    s.records = list(records)
    return s


def test_span_seconds_and_segments():
    s = _spans([("prep", 0, 10), ("attr", 10, 40), ("battery", 40, 100),
                ("prep", 110, 120)])
    assert s.seconds("attr", 0, 200) == 30 / 1e9
    assert s.seconds("prep", 0, 105) == 10 / 1e9
    assert s.segments(5, 200) == [
        (5, 10, "prep"), (10, 40, "attr"), (40, 100, "battery"),
        (100, 110, "between"), (110, 120, "prep"), (120, 200, "between")]
    assert s.segments(50, 60) == [(50, 60, "battery")]
    assert _spans([]).segments(0, 5) == [(0, 5, "between")]


def test_spans_record_around_a_block():
    s = trace.Spans()
    with s("attr"):
        pass
    (label, t0, t1), = s.records
    assert label == "attr" and t1 >= t0


def test_clip_and_busy_per_card():
    events = [(0, -5, 5, "a"), (0, 3, 8, "b"), (1, 20, 30, "a"),
              (1, 95, 120, "c"), (0, 200, 300, "late")]
    cut = trace.clip(events, 0, 100)
    assert cut == [(0, 0, 5, "a"), (0, 3, 8, "b"), (1, 20, 30, "a"),
                   (1, 95, 100, "c")]
    assert trace.busy_seconds(cut, 2) == [8 / 1e9, 15 / 1e9]


def test_breakdown_labels_idle_time():
    s = _spans([("attr", 0, 50), ("battery", 50, 100)])
    events = [(0, 10, 40, "gemm"), (0, 60, 90, "gemm"), (0, 90, 95, "rev")]
    b = trace.breakdown(events, s, 0, 100, 1)
    assert b["device_ops"] == [["gemm", 60 / 1e9], ["rev", 5 / 1e9]]
    # idle 0-10 and 40-50 under attr, 50-60 and 95-100 under battery
    assert dict(b["idle_gaps"]) == pytest.approx({"attr": 20 / 1e9,
                                                  "battery": 15 / 1e9})


def test_breakdown_averages_idle_over_cards():
    s = _spans([])
    b = trace.breakdown([(0, 0, 100, "k")], s, 0, 100, 2)
    assert b["idle_gaps"] == [["between", 50 / 1e9]]
