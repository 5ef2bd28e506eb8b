"""Device ms a chunk in retraction and deletion routing (range
``repro.conn.retraction``: ``csrc/retract.cu``, K5, K4's drains)."""


def read(ctx):
    r = ctx.trace.ranges.get("repro.conn.retraction")
    if not r or not r["device_ms"] or not ctx.units:
        return None
    return r["device_ms"] / ctx.units
