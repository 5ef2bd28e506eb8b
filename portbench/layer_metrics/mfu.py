"""The whole training step's share of the bf16 peak: model flops a step
(``bench/work.py::train_step_flops``; remat's recompute not counted) times
the traced steps, over the traced window, over 989e12, in percent."""
from portbench.bench import peaks


def read(ctx):
    f = ctx.work.get("model_flops_per_step")
    if not f or not ctx.units or not ctx.trace.busy_s:
        return None
    return 100.0 * f * ctx.units / ctx.trace.window_s / peaks.BF16_OPS_PER_S
