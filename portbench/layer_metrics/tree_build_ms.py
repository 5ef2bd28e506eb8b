"""Device ms a chunk in the tree build (range ``repro.conn.tree_build``:
K3 ``csrc/morton_sort.cu``, the assembly ``csrc/leaf_sums.cu``)."""


def read(ctx):
    r = ctx.trace.ranges.get("repro.conn.tree_build")
    if not r or not r["device_ms"] or not ctx.units:
        return None
    return r["device_ms"] / ctx.units
