"""K9's backward share of its roofline: the least time for a call's work
(``bench/work.py::k9_backward``, at the bf16 peak) times its calls (one
dq launch a call), over the device time of the bf16 backward's kernels
(``dq_wgmma``, ``dkdv_wgmma`` and ``group_sum``, or ``dq_bf16`` and
``dkdv_bf16``), in percent."""
from portbench.bench import peaks

KERNELS = ("dq_wgmma", "dkdv_wgmma", "group_sum", "dq_bf16", "dkdv_bf16")
CALLS = ("dq_wgmma", "dq_bf16")


def read(ctx):
    w = ctx.work.get("k9_bwd")
    ms = ctx.trace.kernel_ms(*KERNELS)
    calls = ctx.trace.kernel_count(*CALLS)
    if not w or not ms or not calls:
        return None
    one = peaks.bound(w["bytes"], fp_ops=w["flops"],
                      fp_ops_per_s=peaks.BF16_OPS_PER_S)[0]
    return 100.0 * one * calls / ms
