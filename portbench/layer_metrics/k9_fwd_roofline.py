"""K9's forward share of its roofline: the least time for a call's work
(``bench/work.py::k9_forward``, at the bf16 peak) times its calls, over
the device time of K9's bf16 forward kernels (``flash_bf16_wgmma``, at
D 64 / 128 / 256, or ``flash_bf16``), in percent."""
from portbench.bench import peaks

KERNELS = ("flash_bf16_wgmma", "flash_bf16")


def read(ctx):
    w = ctx.work.get("k9_fwd")
    ms = ctx.trace.kernel_ms(*KERNELS)
    calls = ctx.trace.kernel_count(*KERNELS)
    if not w or not ms:
        return None
    one = peaks.bound(w["bytes"], fp_ops=w["flops"],
                      fp_ops_per_s=peaks.BF16_OPS_PER_S)[0]
    return 100.0 * one * calls / ms
