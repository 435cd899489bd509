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
expansion's convolution, BN and GELU: 21,413 a row at 224 px), and
``mbconv_dense_rows`` those of the calls whose input is dense ``[B, H,
W, C]`` memory (every call, since the forward makes the stem's input
contiguous).
``cnblock_rows`` counts the pixels of each ConvNeXt block call
(``models/convnext.py CNBlock``: batch x H x W, the pixels of its 7x7
depthwise conv and the token rows of its LayerNorm and MLP; 17,199 a row
at convnext_base's 224 px), and ``cnblock_dense_rows`` those of the calls
whose input is dense ``[B, H, W, C]`` memory (every call, since the
forward makes the stem's input contiguous and the convolutions write
channels-last).
``battery_forwards`` counts the forwards of the battery's reveal chunks
(``metrics/curves.py _battery``: a chunk's three passes share a forward
up to 180 rows, so a 224 px battery runs 5 image by image and 15 at four
images).
``layernorm_rows`` counts the token rows of every ``models/common.py
LayerNorm`` call, and ``layernorm_fused_rows`` those of the calls that
took the fused kernel (``kernels/layernorm.py``).  A kernel
wrapper counts its launches in its own ``.launches`` attribute, under the
same lock (:func:`count_launches`).

**Part spans.** ``with part(kind, x):`` around a piece of a forward (or
the IG sweep's backward) records a span named ``part.<kind>``, one of
:data:`PARTS`, under the same gate as :func:`span`; off, it is the same
flag read and shared no-op context.  A host span inside a forward would
time only the enqueue, so where ``x`` is on a CUDA card a part also
records CUDA events on the card's current stream at its entry and its
exit, and its ``device_s`` is the device time between them (None on the
CPU and for every other span).  A part takes no counter snapshot and no
``record_function``, and parts are leaves: one opened while another is
open on the same thread records nothing, its work timed by the outer one,
so the kinds' seconds add up.  Its parent is the innermost span open on
the thread.  The parts are kept apart from the other spans:
``records(parts=True)`` reads them, reading each part's ``device_s``.

A timing event costs an H100 about 3 us where it sits between two
kernels, and its record and read cost the host a few us each, so parts
keep both few.  In a forward decorated :func:`tiled` (whose device work
lies wholly in parts) a part starts at the event that ended the part
before it: one event a part; where the host cannot keep the card fed, a
part's time then also holds the card's wait for its first launch.
Parts are read after the traced window, in :func:`records`; only past
:data:`_PENDING_MAX` unread parts is the oldest read at once.  Events
are the CUDA driver's (``cuEventCreate``), made 4,096 at a time and
reused once read.  The counter ``part_events`` counts the events made,
the most held at once.  A part's record is a tuple of numbers and
strings, which the garbage collector does not track.
"""
from __future__ import annotations

import collections
import contextlib
import ctypes
import functools
import itertools
import threading
import time
import types
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

# the kinds of work a part span times (:func:`part`)
PARTS = ("linear", "conv", "attn", "norm", "pointwise", "layout", "backward")
_PART_NAMES = {kind: "part." + kind for kind in PARTS}
# part spans apart from the others, each an exact tuple of numbers and
# strings, (id, parent, name, thread, card, start_ns, end_ns, timing),
# which the garbage collector stops tracking: a traced window makes ~10^5
# of them, and tracked ones would add collections of the whole heap to it.
# ``timing`` indexes the timings' columns: card, start and end events,
# whether the next part starts at the end one, seconds once read.  Timings
# not yet read, oldest first; by card, the CUDA driver's handles of the
# events free for reuse (kept for the process)
_PARTS: list = []
_T_CARD, _T_START, _T_END, _T_SECONDS = [], [], [], []
_T_SHARED = bytearray()
_PENDING = collections.deque()
_EVENTS = collections.defaultdict(list)
# timings left unread before the oldest is read: twice what a 30 s traced
# window of the benchmark's busiest cell makes (MaxViT-T, ~118,000 on an
# H100), so that none is read inside it
_PENDING_MAX = 1 << 18
_MAKE = 4096                     # events made at a time
_FRESH = ()                      # a tiled forward before its first part
_CU = None
_MS = ctypes.c_float()           # read under _LOCK
_CARD_NAMES = {}
_NOT_READY = 600                 # CUDA_ERROR_NOT_READY
_NO_COUNTS = types.MappingProxyType({})


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
    device_s: Optional[float] = None

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


def part(kind: str, x: torch.Tensor):
    """A context that records the part span ``part.<kind>`` (``kind`` one
    of :data:`PARTS`) around work on ``x``'s device while a profiler
    runs."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _Part(kind, x)


def tiled(forward):
    """Decorates a model's ``forward(self, x, ...)`` whose device work
    lies wholly in part spans: while a profiler runs, each part after its
    first starts at the event that ended the one before, so a part records
    one CUDA event where it would record two (``tests/test_torch_parts.py``
    holds every operator of such a forward inside a part)."""
    @functools.wraps(forward)
    def call(module, *args, **kwargs):
        if not _profiler._is_profiler_enabled:
            return forward(module, *args, **kwargs)
        local = _LOCAL.__dict__
        outer = local.get("chain")
        local["chain"] = _FRESH
        try:
            return forward(module, *args, **kwargs)
        finally:
            # an outer tiled forward's next part starts afresh
            local["chain"] = None if outer is None else _FRESH
    return call


def _driver() -> ctypes.CDLL:
    """The CUDA driver, for the parts' event calls: torch's ``Event``
    wrappers cost 2-3 times as much host time a call (each record also
    asks whether the stream is capturing)."""
    global _CU
    if _CU is None:
        cu = ctypes.CDLL("libcuda.so.1")
        cu.cuEventCreate.argtypes = [ctypes.POINTER(ctypes.c_void_p),
                                     ctypes.c_uint]
        cu.cuEventRecord.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        cu.cuEventSynchronize.argtypes = [ctypes.c_void_p]
        cu.cuEventElapsedTime.argtypes = [ctypes.POINTER(ctypes.c_float),
                                          ctypes.c_void_p, ctypes.c_void_p]
        _CU = cu
    return _CU


def _on_card(card: int, call, *args) -> int:
    """The CUDA driver's ``call(*args)`` with the card's context current (a
    thread's current card may be another: torch's guards put it back
    after each operation)."""
    if torch._C._cuda_getDevice() == card:
        return call(*args)
    with torch.cuda.device(card):
        return call(*args)


def _check(err: int) -> None:
    if err:
        raise RuntimeError(f"CUDA driver error {err} timing a part span")


def _make_events(card: int) -> None:
    """:data:`_MAKE` new timing events of the card into its free list: in
    one go, since a part's host time is the traced forward's cost."""
    create, handle = _driver().cuEventCreate, ctypes.c_void_p()
    with torch.cuda.device(card):
        for _ in range(_MAKE):
            _check(create(ctypes.byref(handle), 0))
            _EVENTS[card].append(handle.value)
    count("part_events", _MAKE)


def _record(card: int, stream: int) -> int:
    """A free timing event of the card recorded on ``stream``: its CUDA
    driver handle."""
    free = _EVENTS[card]
    if not free:
        _make_events(card)
    event = free.pop()
    _check(_on_card(card, _driver().cuEventRecord, event, stream))
    return event


def _read(timing: int) -> None:
    """The seconds between a timing's events, once the card has passed
    the end one; its events go back to be reused (the end one by the next
    part, where that part starts at it: reads go oldest first).  Call
    under _LOCK."""
    card, start, end = _T_CARD[timing], _T_START[timing], _T_END[timing]
    cu = _driver()
    elapsed = (card, cu.cuEventElapsedTime, ctypes.byref(_MS), start, end)
    err = _on_card(*elapsed)
    if err == _NOT_READY:
        _check(_on_card(card, cu.cuEventSynchronize, end))
        err = _on_card(*elapsed)
    _check(err)
    _T_SECONDS[timing] = _MS.value / 1e3
    _release(timing)


def _release(timing: int) -> None:
    free = _EVENTS[_T_CARD[timing]]
    free.append(_T_START[timing])
    if not _T_SHARED[timing]:
        free.append(_T_END[timing])


def _card_name(x: torch.Tensor) -> str:
    """``str(x.device)``, kept by device."""
    device = x.device
    name = _CARD_NAMES.get(device)
    if name is None:
        name = _CARD_NAMES[device] = str(device)
    return name


class _Part:
    __slots__ = ("name", "x", "inner", "parent", "card", "stream", "start",
                 "start_ns")

    def __init__(self, kind, x):
        self.name, self.x = _PART_NAMES[kind], x

    def __enter__(self) -> None:
        local = _LOCAL.__dict__
        self.inner = local.get("part", False)
        if self.inner:
            return
        local["part"] = True
        stack = local.get("stack")
        self.parent = stack[-1] if stack else None
        card = self.card = self.x.get_device()
        if card >= 0:
            stream = self.stream = torch._C._cuda_getCurrentRawStream(card)
            chain = local.get("chain")
            if (chain and chain[0] == stream
                    and _T_SECONDS[chain[1]] is None):
                _T_SHARED[chain[1]] = 1
                self.start = _T_END[chain[1]]
            else:
                self.start = _record(card, stream)
        self.start_ns = time.time_ns()

    def __exit__(self, *exc) -> bool:
        if self.inner:
            return False
        local = _LOCAL.__dict__
        card = self.card
        end = _record(card, self.stream) if card >= 0 else None
        end_ns = time.time_ns()
        local["part"] = False
        thread = threading.current_thread().name
        with _LOCK:
            timing = None
            if end is not None:
                timing = len(_T_START)
                _T_CARD.append(card)
                _T_START.append(self.start)
                _T_END.append(end)
                _T_SHARED.append(0)
                _T_SECONDS.append(None)
                _PENDING.append(timing)
                if len(_PENDING) > _PENDING_MAX:
                    _read(_PENDING.popleft())
            _PARTS.append((next(_IDS), self.parent, self.name, thread,
                           _card_name(self.x), self.start_ns, end_ns,
                           timing))
        if timing is not None and local.get("chain") is not None:
            local["chain"] = (self.stream, timing)
        return False


def records(lo_ns: Optional[int] = None, hi_ns: Optional[int] = None,
            parts: bool = False) -> List[Span]:
    """The recorded spans that start in ``[lo_ns, hi_ns)`` (either end
    open when None), by start: the part spans with their ``device_s``
    where ``parts``, else the others."""
    with _LOCK:
        if parts:
            while _PENDING:
                _read(_PENDING.popleft())
            out = [Span(*p[:7], _NO_COUNTS, _NO_COUNTS,
                        None if p[7] is None else _T_SECONDS[p[7]])
                   for p in _PARTS]
        else:
            out = list(_RECORDS)
    return sorted((s for s in out
                   if (lo_ns is None or s.start_ns >= lo_ns)
                   and (hi_ns is None or s.start_ns < hi_ns)),
                  key=lambda s: s.start_ns)


def clear() -> None:
    with _LOCK:
        _RECORDS.clear()
        _PARTS.clear()
        while _PENDING:
            _release(_PENDING.popleft())
        for column in (_T_CARD, _T_START, _T_END, _T_SECONDS, _T_SHARED):
            column.clear()
