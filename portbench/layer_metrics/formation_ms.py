"""Device ms a chunk in formation (range ``repro.conn.formation``: the
requests, K2 ``csrc/bh_traverse.cu``, K4's keyed accept)."""


def read(ctx):
    r = ctx.trace.ranges.get("repro.conn.formation")
    if not r or not r["device_ms"] or not ctx.units:
        return None
    return r["device_ms"] / ctx.units
