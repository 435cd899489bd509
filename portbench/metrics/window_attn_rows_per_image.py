"""Query rows of the program's windowed attention an image scored: the
growth of its ``window_attn_rows`` counter (``models/swin.py
WindowAttention`` adds windows times tokens a window at each call) over
the window's top-level spans, over the images scored, as
``model_rows_per_image`` reads ``model_rows``.  None without the
program's spans, or where no span carries the counter (a program that
lacks it, or a model without windowed attention)."""
from portbench.program_trace import spans


def per_image(ctx, counter: str):
    """The growth of ``counter`` over the window's top-level spans, an
    image; None where no span carries it."""
    top = [s for s in spans(ctx) if s.parent is None]
    if not ctx["images"] or not any(counter in s.counts_end for s in top):
        return None
    return sum(s.counted(counter) for s in top) / ctx["images"]


def read(ctx):
    return per_image(ctx, "window_attn_rows")
