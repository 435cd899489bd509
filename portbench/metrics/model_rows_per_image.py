"""Rows through the program's model forwards an image scored: the growth
of the program's ``model_rows`` counter (every ``ModelBundle`` entry
that runs the module adds its batch's rows) over the window's top-level
spans (those without a parent: the driver step's calls), over the images
scored.  The spans give the counter's value at their ends, so the
set-up's warm step, outside any traced span, is not counted.  None
without the program's spans."""
from portbench.program_trace import spans


def read(ctx):
    top = [s for s in spans(ctx) if s.parent is None]
    if not top or not ctx["images"]:
        return None
    return sum(s.counted("model_rows") for s in top) / ctx["images"]
