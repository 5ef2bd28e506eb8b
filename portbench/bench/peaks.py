"""The datasheet peaks of one NVIDIA H100 SXM and the least time for a
piece of work on them.

Copied from ``chip_smoke.py`` (``H100_*`` and ``bound``), where the
rates are derived: HBM 3.35e12 B/s; FP32 outside the tensor cores
67e12/s; dense bf16 tensor cores 989e12/s; INT32 64 results an SM a clock
on 132 SMs at 1,980 MHz, 16.7e12/s. Integer and float operations issue on
separate pipes, so the bound takes the longer of their times, and the
longer of that and the bytes' time.
"""
from __future__ import annotations

BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
BF16_OPS_PER_S = 989e12
INT32_OPS_PER_S = 64 * 132 * 1.98e9


def bound(nbytes: float, int_ops: float = 0.0, fp_ops: float = 0.0,
          fp_ops_per_s: float = FP32_OPS_PER_S):
    """(ms, "bytes" or "operations"): the least time for the work."""
    tb = nbytes / BYTES_PER_S * 1e3
    to = max(int_ops / INT32_OPS_PER_S, fp_ops / fp_ops_per_s) * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")
