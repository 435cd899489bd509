"""The summed device seconds of the program's part spans (``xai_tpu_torch/
utils/trace.py part``: the seven kinds linear, conv, attn, norm,
pointwise, layout and backward, timed between two CUDA events on the
card) that start in the window, as a share of the cards times the
window's seconds.  Parts never nest, so it is at most 100; it leaves out
the battery's blur and reveal kernels, the cards' idle time and what no
part covers.  None where no part span of the window has ``device_s``: a
program without part spans (its ``trace.records`` takes no ``parts``),
or one that ran on no card.  :func:`per_image` serves the readers of
each kind."""
import inspect


def part_seconds(ctx) -> dict:
    """``{kind: summed device_s}`` of the program's part spans that start
    in the window and have ``device_s``; {} where there are none."""
    try:
        from xai_tpu_torch.utils import trace
    except ImportError:
        return {}
    if "parts" not in inspect.signature(trace.records).parameters:
        return {}
    out = {}
    for s in trace.records(ctx["lo_ns"], ctx["hi_ns"], parts=True):
        if s.device_s is not None:
            kind = s.name.split(".", 1)[1]
            out[kind] = out.get(kind, 0.0) + s.device_s
    return out


def per_image(ctx, kind: str):
    """The summed device seconds of the window's ``kind`` parts over the
    images scored; None where no such part has ``device_s``."""
    seconds = part_seconds(ctx)
    if kind not in seconds or not ctx["images"]:
        return None
    return seconds[kind] / ctx["images"]


def read(ctx):
    seconds = part_seconds(ctx)
    if not seconds:
        return None
    return 100.0 * sum(seconds.values()) / (ctx["cards"] * ctx["window_s"])
