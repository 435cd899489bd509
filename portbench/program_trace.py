"""The program's own spans (``xai_tpu_torch/utils/trace.py``) for the
metrics that read them.

The program records spans only while a ``torch.profiler`` runs, so only
a traced run's window has them; a program without the module has none.
Either way the readers find no spans and return None."""

# the battery's host scoring: the flip steps' argsorts and the 10 scores
HOST_SCORING = ("battery.schedule", "battery.score")


def spans(ctx) -> list:
    """The program's spans that start in the window ``[lo_ns, hi_ns)``,
    by start; [] where there are none."""
    try:
        from xai_tpu_torch.utils import trace
    except ImportError:
        return []
    return trace.records(ctx["lo_ns"], ctx["hi_ns"])


def seconds(spans, names) -> float:
    """The summed seconds of the spans named in ``names``."""
    return sum(s.end_ns - s.start_ns for s in spans if s.name in names) / 1e9
