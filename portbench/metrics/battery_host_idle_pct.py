"""The share of the window in which a card is idle while the battery's
host scoring runs: the gaps in the union of the card's traced kernel,
copy and set intervals (as ``device_idle_pct`` counts them) that fall
inside a program's ``battery.schedule`` or ``battery.score`` span,
averaged over the cell's cards.  None without a device trace or without
the program's spans."""
from portbench.program_trace import HOST_SCORING, spans
from portbench.trace import Spans, breakdown


def read(ctx):
    host = [s for s in spans(ctx) if s.name in HOST_SCORING]
    if not ctx["traced"] or not host:
        return None
    marks = Spans()
    marks.records = [("host", s.start_ns, s.end_ns) for s in host]
    idle = dict(breakdown(ctx["events"], marks, ctx["lo_ns"], ctx["hi_ns"],
                          ctx["cards"])["idle_gaps"])
    return 100.0 * idle.get("host", 0.0) / ctx["window_s"]
