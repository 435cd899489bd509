"""Seconds of the program's ``normalize_input`` and ``image_gates``
spans (``runners/common.py``: the image's copy to the card, and the
target's forward read back to the host) in the window, over the images
scored (host clock).  None without the program's spans."""
from portbench.program_trace import seconds, spans


def read(ctx):
    found = spans(ctx)
    if not found or not ctx["images"]:
        return None
    return seconds(found, ("normalize_input", "image_gates")) / ctx["images"]
