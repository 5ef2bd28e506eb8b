"""K1's share of its roofline over the traced chunks: the least time for
the windows' work (``bench/work.py::k1_window``, on the in-edges each
window read) over K1's device time, in percent."""
from portbench.bench import peaks


def read(ctx):
    ms = ctx.trace.kernel_ms("activity_window_kernel")
    k1 = ctx.work.get("k1")
    if not ms or not k1:
        return None
    return 100.0 * peaks.bound(k1["bytes"], k1["int_ops"], k1["fp_ops"])[0] \
        / ms
