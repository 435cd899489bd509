"""Seconds of the battery's host scoring in the window, over the images
scored (host clock): the program's ``battery.schedule`` spans (the flip
steps' argsorts, ``metrics/curves.py flip_schedules``) and
``battery.score`` spans (the 10 scores from the curves' host copy,
``assemble_scores``).  None without the program's spans."""
from portbench.program_trace import HOST_SCORING, seconds, spans


def read(ctx):
    found = spans(ctx)
    if not found or not ctx["images"]:
        return None
    return seconds(found, HOST_SCORING) / ctx["images"]
