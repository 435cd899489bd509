"""The port's own spans and counters.

``with span(name):`` around a layer's call records a :class:`Span`: its
id, its parent's, its name, the thread and the card it ran for, its start
and end on ``time.time_ns()`` (the clock ``torch.profiler`` stamps its
host and device events with, so spans and a device trace share one
timeline), and every counter's value at its start and its end.

A span records only while a ``torch.profiler`` runs, whatever its
activities: the gate is ``torch.autograd.profiler._is_profiler_enabled``,
a process-wide flag read at each call (the thread-local
``torch._C._autograd._profiler_enabled()`` reads False in a pool thread).
With no profiler a span is that one read and a shared no-op context: it
synchronises nothing and enqueues nothing.  With one, a span also enters
``torch.profiler.record_function(name)``, so that a Chrome trace of a CPU
profile (``evaluate_perturbation --profile_dir``) shows the span above the
operators it ran.

The parent is the innermost span open on the calling thread, or
``parent=``, the id a ``with span(...) as sid:`` gives, for work handed to
another thread.  Spans stay in memory until :func:`clear`;
:func:`records` reads them back.  A reader owns that store: the
benchmark reads its window's spans, and a profiled driver run
(``--profile_dir``), which reads none, keeps its ~10 spans a step (a
few hundred bytes each) until it exits, beside the profiler's own
thousands of events a step.

Counters are always on: :func:`count` adds to one under a lock, safely
from any thread.  ``model_rows`` counts the rows of every forward that
enters a model at its input: the ``ModelBundle`` entries, and the
methods that run the module themselves.  ``window_attn_rows`` counts the
query rows of windowed attention (``models/swin.py WindowAttention``:
windows times tokens a window, in Swin's blocks and MaxViT's block and
grid layers), and ``masked_window_rows`` those of the calls that carry a
shift mask (Swin's shifted blocks); 11,466 and 5,684 a model row at
Swin-B's 224 px, 17,836 and 0 at MaxViT-T's.  ``grid_attn_rows`` counts
the query rows of MaxViT's grid attention (``models/maxvit.py
AttnLayer``: groups times tokens a group, 8,918 a row at 224 px, a part
of ``window_attn_rows``), and ``mbconv_rows`` the input pixels of each of
its MBConv calls (batch times input pixels, the resolution of the
expansion's convolution, BN and GELU: 21,413 a row at 224 px).
``battery_forwards`` counts the forwards of the battery's reveal chunks
(``metrics/curves.py _battery``: a chunk's three passes share a forward
up to 180 rows, so a 224 px battery runs 5 image by image and 15 at four
images).
``layernorm_rows`` counts the token rows of every ``models/common.py
LayerNorm`` call, and ``layernorm_fused_rows`` those of the calls that
took the fused kernel (``kernels/layernorm.py``).  A kernel
wrapper counts its launches in its own ``.launches`` attribute, under the
same lock (:func:`count_launches`).
"""
from __future__ import annotations

import collections
import contextlib
import itertools
import threading
import time
from typing import List, NamedTuple, Optional

import torch
from torch.autograd import profiler as _profiler

# counters and spans are shared by every thread: a mesh battery launches
# from one host thread a data shard (metrics/curves.py)
_LOCK = threading.Lock()
_COUNTS = collections.Counter()
_RECORDS: List["Span"] = []
_IDS = itertools.count(1)
_LOCAL = threading.local()
_OFF = contextlib.nullcontext()


class Span(NamedTuple):
    id: int
    parent: Optional[int]
    name: str
    thread: str
    card: Optional[str]
    start_ns: int
    end_ns: int
    counts_start: dict
    counts_end: dict

    def counted(self, counter: str) -> int:
        """How much ``counter`` grew while the span was open (on every
        thread)."""
        return (self.counts_end.get(counter, 0)
                - self.counts_start.get(counter, 0))


def count(counter: str, n: int = 1) -> None:
    with _LOCK:
        _COUNTS[counter] += n


def count_launches(wrapper, n: int = 1) -> None:
    """Add ``n`` launches to a kernel wrapper's ``.launches``."""
    with _LOCK:
        wrapper.launches += n


def counters() -> dict:
    with _LOCK:
        return dict(_COUNTS)


def span(name: str, parent: Optional[int] = None,
         card: Optional[str] = None):
    """A context that records the span ``name`` while a profiler runs
    (``as``: its id, or None when not recording)."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _Recording(name, parent, card)


class _Recording:
    def __init__(self, name, parent, card):
        self.name, self.parent, self.card = name, parent, card

    def __enter__(self) -> int:
        stack = _LOCAL.__dict__.setdefault("stack", [])
        if self.parent is None and stack:
            self.parent = stack[-1]
        with _LOCK:
            self.id = next(_IDS)
            self.counts = dict(_COUNTS)
        stack.append(self.id)
        self.start = time.time_ns()
        self.annotation = torch.profiler.record_function(self.name)
        self.annotation.__enter__()
        return self.id

    def __exit__(self, *exc) -> bool:
        self.annotation.__exit__(*exc)
        end = time.time_ns()
        _LOCAL.stack.pop()
        with _LOCK:
            _RECORDS.append(Span(
                self.id, self.parent, self.name,
                threading.current_thread().name, self.card, self.start, end,
                self.counts, dict(_COUNTS)))
        return False


def records(lo_ns: Optional[int] = None,
            hi_ns: Optional[int] = None) -> List[Span]:
    """The recorded spans that start in ``[lo_ns, hi_ns)`` (either end
    open when None), by start."""
    with _LOCK:
        out = list(_RECORDS)
    return sorted((s for s in out
                   if (lo_ns is None or s.start_ns >= lo_ns)
                   and (hi_ns is None or s.start_ns < hi_ns)),
                  key=lambda s: s.start_ns)


def clear() -> None:
    with _LOCK:
        _RECORDS.clear()
