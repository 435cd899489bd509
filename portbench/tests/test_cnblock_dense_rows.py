"""The reader of the program's ``cnblock_dense_rows`` counter (ConvNeXt
block pixels whose input was dense ``[B, H, W, C]`` memory): it imports,
reads the counter's growth over the window's top-level spans per image
scored, and reads nothing from a program without the counter, as the
readers of ``test_convnext.py`` do."""
import sys

import pytest

import xai_tpu_torch.utils
from portbench.metrics import (cnblock_dense_rows_per_image,
                               cnblock_rows_per_image)
from xai_tpu_torch.utils import trace

COUNTERS = ("cnblock_rows", "cnblock_dense_rows")


def _span(i, parent, s, e, rows):
    return trace.Span(i, parent, "battery", "MainThread", None, s, e,
                      dict(zip(COUNTERS, rows[0])),
                      dict(zip(COUNTERS, rows[1])))


def _ctx(images=2):
    return {"lo_ns": 100, "hi_ns": 1000, "images": images}


# two top-level spans in [100, 1000), the first with a strided call (its
# dense rows lag its rows), and a child whose rows are inside its
# parent's; a span of the set-up before the window
SPANS = [_span(1, None, 100, 400, ((0, 0), (17199, 16000))),
         _span(2, None, 400, 900, ((17199, 16000), (34398, 33199))),
         _span(3, 2, 500, 600, ((17199, 16000), (20000, 18801))),
         _span(4, None, 10, 20, ((0, 0), (99, 99)))]


def test_dense_rows_reader_imports():
    assert callable(cnblock_dense_rows_per_image.read)


@pytest.mark.parametrize("images,want", [(2, 33199 / 2), (1, 33199)])
def test_dense_rows_count_top_level_spans(images, want, monkeypatch):
    monkeypatch.setattr(trace, "_RECORDS", SPANS)
    assert cnblock_dense_rows_per_image.read(_ctx(images)) == want
    assert cnblock_rows_per_image.read(_ctx(images)) == 34398 / images


def test_dense_rows_read_nothing_from_a_program_without_them(monkeypatch):
    """A program that counts ``cnblock_rows`` but not
    ``cnblock_dense_rows`` (the strided layout's) reads the one and not the
    other."""
    older = [s._replace(
        counts_start={k: v for k, v in s.counts_start.items()
                      if k != "cnblock_dense_rows"},
        counts_end={k: v for k, v in s.counts_end.items()
                    if k != "cnblock_dense_rows"}) for s in SPANS]
    monkeypatch.setattr(trace, "_RECORDS", older)
    assert cnblock_rows_per_image.read(_ctx()) == 17199
    assert cnblock_dense_rows_per_image.read(_ctx()) is None


def test_dense_rows_read_nothing_without_spans_or_trace(monkeypatch):
    """Spans of a model without ConvNeXt blocks read nothing, as does a program
    without the trace module."""
    bare = [s._replace(counts_start={"model_rows": 0},
                       counts_end={"model_rows": 5}) for s in SPANS]
    monkeypatch.setattr(trace, "_RECORDS", bare)
    assert cnblock_dense_rows_per_image.read(_ctx()) is None
    monkeypatch.setattr(trace, "_RECORDS", SPANS)
    assert cnblock_dense_rows_per_image.read(_ctx()) is not None
    monkeypatch.delattr(xai_tpu_torch.utils, "trace")
    monkeypatch.setitem(sys.modules, "xai_tpu_torch.utils.trace", None)
    assert cnblock_dense_rows_per_image.read(_ctx()) is None
