"""The reveal kernel's share of its roofline: the least time of the
reveal work the window's steps needed (3 passes of ``[B, 45, 3, H, W]``
chunks a step, bytes over the H100's 3.35 TB/s, ``yardstick.py``) over
the device time of the kernels named ``reveal`` in the trace.  None
without a trace or without such kernels."""
from portbench.yardstick import reveal_bound_per_step_s


def read(ctx):
    t = sum(e - s for _, s, e, name in ctx["events"] if "reveal" in name)
    if not t:
        return None
    bound = ctx["steps"] * reveal_bound_per_step_s(
        ctx["cfg"]["img_hw"], ctx["traffic"]["image_batch"],
        ctx["traffic"]["battery"]["chunk"])
    return 100.0 * bound / (t / 1e9)
