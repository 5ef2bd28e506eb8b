"""The device's idle share of the traced training steps, in percent."""


def read(ctx):
    t = ctx.trace
    if not t.busy_s or not t.window_s:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
