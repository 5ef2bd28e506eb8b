"""Device ms a chunk in the activity phase (range ``repro.activity``:
K1, ``csrc/activity_window.cu``)."""


def read(ctx):
    r = ctx.trace.ranges.get("repro.activity")
    if not r or not r["device_ms"] or not ctx.units:
        return None
    return r["device_ms"] / ctx.units
