"""ConvNeXt-B's memory layouts on a CUDA card: each convolution under
each layout, and one 180-row no-grad forward by part.

Layout probes (float32, TF32 off, 180 rows, CUDA events, the median of 5
after 2 warm runs): the 7x7 depthwise conv at the four stage shapes, the
three 2x2 stride-2 downsampling convs and the 4x4 stride-4 stem, each
forward and input gradient, from NCHW memory (``nchw``), from the
channels-last view of dense ``[B, H, W, C]`` memory (``cl``), and from
dense memory through an NCHW copy and back (``copy``: what the model pays
to keep one conv on NCHW).  The stem's ``nchw`` also makes its output
dense NHWC, and its ``cl`` makes the image's; each line gives the largest
difference of the ``cl`` output and input gradient from ``nchw``'s,
relative to its largest value.

Forward probe: convnext_base (flax's init), one 180-row no-grad forward,
CUDA events at the hooks of each top-level module and each block's
``dwconv``, ``norm``, ``pw1`` and ``pw2``, summed by part (the median of
5); ``--variants`` also sends the depthwise (``dw_copy``) or the downsampling
(``down_copy``) convs through an NCHW copy.  Then the ops by their own
device time in one profiled forward, and a 100-row forward and input
gradient (the IG sweep's chunk) with its peak memory.

    python3 tools/convnext_layout_probe.py [--root DIR] [--forward_only]
        [--variants cl,dw_copy,down_copy]

``--root`` imports ``xai_tpu_torch`` from another checkout, to time an
older commit's forward in the same call.  Prints JSON lines.
"""
import argparse
import json
import os
import statistics
import subprocess
import sys

import torch
import torch.nn as nn

ROWS = 180
STAGES = [(128, 56), (256, 28), (512, 14), (1024, 7)]


def _median_ms(fn, pre=tuple, reps=5, warm=2):
    """Median device ms of ``fn(*pre())`` between two CUDA events, ``pre``
    run outside them."""
    times = []
    for i in range(warm + reps):
        args = pre()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(*args)
        end.record()
        torch.cuda.synchronize()
        if i >= warm:
            times.append(start.elapsed_time(end))
    return statistics.median(times)


def _rel(a, b):
    return ((a.double() - b.double()).abs().max()
            / b.double().abs().max()).item()


def _layouts(conv, nhwc, image=False):
    """``{layout: [forward ms, input-gradient ms]}`` of ``conv`` for a
    dense ``[B, H, W, C]`` batch ``nhwc``, and the relative differences of
    the ``cl`` output and input gradient from ``nchw``'s.  For the stem
    (``image``) both layouts start from the NCHW image and end dense."""
    nchw = nhwc.permute(0, 3, 1, 2).contiguous()

    def dense(y):
        return y.permute(0, 2, 3, 1).contiguous()
    if image:
        runs = {"nchw": (nchw, lambda v: dense(conv(v))),
                "cl": (nchw, lambda v: dense(conv(dense(v).permute(
                    0, 3, 1, 2))))}
    else:
        runs = {"nchw": (nchw, conv),
                "cl": (nhwc, lambda v: dense(conv(v.permute(0, 3, 1, 2)))),
                "copy": (nhwc, lambda v: dense(conv(v.permute(
                    0, 3, 1, 2).contiguous())))}
    with torch.no_grad():
        # one cotangent, dense, for every layout
        cot = torch.randn_like(runs["cl"][1](runs["cl"][0]))
    times, got = {}, {}
    for name, (x, fn) in runs.items():
        with torch.no_grad():
            fwd = _median_ms(lambda: fn(x))
        xg = x.detach().requires_grad_(True)
        g = cot.permute(0, 3, 1, 2) if name == "nchw" and not image else cot

        bwd = _median_ms(lambda y: torch.autograd.grad(y, xg, g),
                         pre=lambda: (fn(xg),))
        times[name] = [round(fwd, 4), round(bwd, 4)]
        y = fn(xg)
        (gx,) = torch.autograd.grad(y, xg, g)
        if name == "nchw" and not image:
            y, gx = y.permute(0, 2, 3, 1), gx.permute(0, 2, 3, 1)
        got[name] = (y.detach(), gx)
    return times, [_rel(got["cl"][k], got["nchw"][k]) for k in (0, 1)]


def layout_probes(dev):
    gen = torch.Generator(device=dev).manual_seed(0)

    def batch(c, s):
        return torch.randn((ROWS, s, s, c), device=dev, generator=gen)

    for c, s in STAGES:
        conv = nn.Conv2d(c, c, 7, padding=3, groups=c).to(dev)
        conv.requires_grad_(False)
        ms, diff = _layouts(conv, batch(c, s))
        print(json.dumps({"probe": "depthwise7x7", "shape": [ROWS, c, s, s],
                          "fwd_bwd_ms": ms, "cl_rel_diff": diff}),
              flush=True)
    from xai_tpu_torch.models.common import Conv2dSame
    for (cin, s), (cout, _) in zip(STAGES, STAGES[1:]):
        conv = Conv2dSame(cin, cout, 2, stride=2).to(dev)
        conv.requires_grad_(False)
        ms, diff = _layouts(conv, batch(cin, s))
        print(json.dumps({"probe": "down2x2", "shape": [ROWS, cin, s, s],
                          "cout": cout, "fwd_bwd_ms": ms,
                          "cl_rel_diff": diff}), flush=True)
    conv = Conv2dSame(3, 128, 4, stride=4).to(dev)
    conv.requires_grad_(False)
    ms, diff = _layouts(conv, batch(3, 224), image=True)
    print(json.dumps({"probe": "stem4x4", "shape": [ROWS, 3, 224, 224],
                      "fwd_bwd_ms": ms, "cl_rel_diff": diff}), flush=True)


def _part(label):
    """The part an interval between two hook marks belongs to, by the
    first mark's module and side (``in`` before the call, ``out``
    after)."""
    name, side = label.rsplit(":", 1)
    leaf = name.rsplit(".", 1)[-1]
    if leaf in ("start", "stem_conv"):
        return "stem_conv"
    if leaf == "dwconv":
        return "depthwise"
    if leaf.endswith("norm"):
        if side == "in":
            return "layernorm"
        return "down_conv" if leaf.startswith("down") else "other"
    if leaf.startswith("down"):
        return "down_conv"
    if leaf in ("pw1", "pw2"):
        return leaf if side == "in" else {"pw1": "gelu",
                                          "pw2": "scale_skip"}[leaf]
    return "head" if leaf == "head" and side == "in" else "other"


def forward_by_part(model, x, reps=5):
    marks = []

    def mark(label):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append((label, ev))

    hooks = []
    for name, mod in model.named_modules():
        leaf = name.rsplit(".", 1)[-1]
        if name and ("." not in name
                     or leaf in ("dwconv", "norm", "pw1", "pw2")):
            hooks.append(mod.register_forward_pre_hook(
                lambda m, i, n=name: mark(n + ":in")))
            hooks.append(mod.register_forward_hook(
                lambda m, i, o, n=name: mark(n + ":out")))
    runs = []
    with torch.no_grad():
        for i in range(2 + reps):
            marks.clear()
            mark("start:in")
            model(x)
            mark("end:in")
            torch.cuda.synchronize()
            if i < 2:
                continue
            parts = {}
            for (a, ea), (_, eb) in zip(marks, marks[1:]):
                key = _part(a)
                parts[key] = parts.get(key, 0.0) + ea.elapsed_time(eb)
                if key == "pw1":
                    key = "pw1_" + a.split("_", 1)[0]
                    parts[key] = parts.get(key, 0.0) + ea.elapsed_time(eb)
            parts["total"] = marks[0][1].elapsed_time(marks[-1][1])
            runs.append(parts)
    for h in hooks:
        h.remove()
    return {k: round(statistics.median(r[k] for r in runs), 3)
            for k in runs[0]}


def op_table(model, x, top=14):
    from torch.profiler import ProfilerActivity, profile
    with torch.no_grad():
        model(x)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            model(x)
            torch.cuda.synchronize()

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0))
    evs = sorted(prof.key_averages(), key=dev_us, reverse=True)[:top]
    return [[e.key, e.count, round(dev_us(e) / 1e3, 3)] for e in evs]


def _variant(convnext, name):
    """Send the depthwise or the downsampling convs through an NCHW
    copy, where the checkout has the dense layout's ``_conv_dense``."""
    dense = getattr(convnext, "_conv_dense", None)
    if name == "cl" or dense is None:
        return

    def conv(c, x):
        copy = (c.groups > 1) if name == "dw_copy" else (
            c.groups == 1 and c.in_channels > 3)
        if not copy:
            return dense(c, x)
        return c(x.permute(0, 3, 1, 2).contiguous()).permute(
            0, 2, 3, 1).contiguous()
    convnext._conv_dense = conv


def forward_probes(dev, variants):
    from xai_tpu_torch.models import convnext
    from xai_tpu_torch.models.common import init_flax_default
    model = init_flax_default(convnext.ConvNeXt(
        **convnext.ARCHS["convnext_base"]), 0).to(dev).requires_grad_(False)
    gen = torch.Generator(device=dev).manual_seed(1)
    x = torch.randn((ROWS, 3, 224, 224), device=dev, generator=gen)
    dense = getattr(convnext, "_conv_dense", None)
    for name in variants:
        _variant(convnext, name)
        print(json.dumps({"probe": "forward", "variant": name,
                          "dense_layout": dense is not None,
                          "ms": forward_by_part(model, x)}), flush=True)
        if dense is not None:
            convnext._conv_dense = dense
    print(json.dumps({"probe": "ops", "ops_ms": op_table(model, x)}),
          flush=True)
    xg = torch.randn((100, 3, 224, 224), device=dev, generator=gen)

    def sweep():
        v = xg.detach().requires_grad_(True)
        torch.autograd.grad(model(v)[:, 0].sum(), v)
    torch.cuda.reset_peak_memory_stats(dev)
    ms = _median_ms(sweep)
    print(json.dumps({"probe": "fwd_bwd_100", "ms": round(ms, 3),
                      "peak_gib": round(torch.cuda.max_memory_allocated(dev)
                                        / 2 ** 30, 3)}), flush=True)


def main():
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    p = argparse.ArgumentParser()
    p.add_argument("--root", default=here)
    p.add_argument("--forward_only", action="store_true")
    p.add_argument("--variants", default="cl,dw_copy,down_copy")
    a = p.parse_args()
    sys.path.insert(0, os.path.abspath(a.root))
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    dev = torch.device("cuda", 0)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(json.dumps({"card": card.strip(), "torch": torch.__version__,
                      "root": os.path.abspath(a.root)}), flush=True)
    if not a.forward_only:
        layout_probes(dev)
    forward_probes(dev, a.variants.split(","))


if __name__ == "__main__":
    main()
