"""Spans on the host clock and the device trace of the measured window.

:class:`Spans` records the benchmark's own spans around its calls into
the program's layers (``prep``: normalize and the target forward;
``attr``: the attribution; ``battery``: the 10-score battery), each as
``(label, start_ns, end_ns)`` on ``time.time_ns``, the clock that
``torch.profiler`` stamps its events with.

:class:`DeviceTrace` runs ``torch.profiler`` with CUDA activity only
(CUPTI records each kernel, copy and set on the card; host operators are
not recorded, so the host runs at its untraced pace) around the window,
and reads the records back as ``(card, start_ns, end_ns, name)``.
"""
from __future__ import annotations

import bisect
import collections
import contextlib
import time

from .yardstick import busy_us


class Spans:
    def __init__(self):
        self.records = []

    @contextlib.contextmanager
    def __call__(self, label: str):
        t0 = time.time_ns()
        try:
            yield
        finally:
            self.records.append((label, t0, time.time_ns()))

    def seconds(self, label: str, lo_ns: int, hi_ns: int) -> float:
        """Seconds of ``label`` spans that start inside [lo, hi)."""
        return sum(e - s for lab, s, e in self.records
                   if lab == label and lo_ns <= s < hi_ns) / 1e9

    def segments(self, lo_ns: int, hi_ns: int) -> list:
        """[lo, hi) cut into ``(start, end, label)`` pieces: each span's
        part inside it, and ``between`` where no span is open (the spans
        are sequential)."""
        out, cur = [], lo_ns
        for s, e, label in sorted((s, e, lab) for lab, s, e in
                                  self.records):
            s, e = max(s, cur), min(e, hi_ns)
            if e <= s:
                continue
            if s > cur:
                out.append((cur, s, "between"))
            out.append((s, e, label))
            cur = e
        if cur < hi_ns:
            out.append((cur, hi_ns, "between"))
        return out


class DeviceTrace:
    """``with DeviceTrace(enabled):`` traces the block when enabled."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.events = []
        self._prof = None

    def __enter__(self):
        if self.enabled:
            from torch.profiler import ProfilerActivity, profile
            self._prof = profile(activities=[ProfilerActivity.CUDA])
            self._prof.__enter__()
        return self

    def __exit__(self, *exc):
        if self._prof is None:
            return False
        from torch.autograd import DeviceType
        self._prof.__exit__(*exc)
        for e in self._prof.profiler.kineto_results.events():
            if e.device_type() == DeviceType.CUDA and e.duration_ns() > 0:
                self.events.append((e.device_index(), e.start_ns(),
                                    e.start_ns() + e.duration_ns(),
                                    e.name()))
        self._prof = None
        return False


def clip(events, lo_ns: int, hi_ns: int) -> list:
    """The events' intervals cut to [lo, hi), per event."""
    out = []
    for card, s, e, name in events:
        s, e = max(s, lo_ns), min(e, hi_ns)
        if e > s:
            out.append((card, s, e, name))
    return out


def busy_seconds(events, cards: int) -> list:
    """Seconds in which some operation ran, per card ``0..cards-1``."""
    by_card = collections.defaultdict(list)
    for card, s, e, _ in events:
        by_card[card].append((s, e))
    return [busy_us(by_card[c]) / 1e9 for c in range(cards)]


def breakdown(events, spans: Spans, lo_ns: int, hi_ns: int, cards: int,
              top: int = 10) -> dict:
    """The device operations that took most time (seconds summed over
    the cards), and the device's idle time by what the host was doing
    at each moment of it (the span then open; seconds, averaged over the
    cards)."""
    ops = collections.Counter()
    by_card = collections.defaultdict(list)
    for card, s, e, name in events:
        ops[name] += (e - s) / 1e9
        by_card[card].append((s, e))
    segs = spans.segments(lo_ns, hi_ns)
    starts = [s for s, _, _ in segs]
    idle = collections.Counter()
    for c in range(cards):
        cur = lo_ns
        for s, e in sorted(by_card[c]) + [(hi_ns, hi_ns)]:
            if s > cur:
                i = max(bisect.bisect_right(starts, cur) - 1, 0)
                while i < len(segs) and segs[i][0] < s:
                    a, b = max(segs[i][0], cur), min(segs[i][1], s)
                    if b > a:
                        idle[segs[i][2]] += (b - a) / 1e9 / cards
                    i += 1
            cur = max(cur, e)
    return {"device_ops": [[n, v] for n, v in ops.most_common(top)],
            "idle_gaps": [[n, v] for n, v in idle.most_common(top)]}
