"""K2's share of its roofline at the sampled chunk: the least time for
the search these inputs need (``bench/work.py::k2_work``) over the device
time of K2's kernels launched in that chunk, in percent."""
from portbench.bench import peaks


def read(ctx):
    ms = ctx.trace.kernel_ms("bh_traverse_kernel", "pack_nodes_kernel",
                             sample=True)
    k2 = ctx.work.get("k2")
    if not ms or not k2:
        return None
    return 100.0 * peaks.bound(k2["bytes"], k2["int_ops"], k2["fp_ops"])[0] \
        / ms
