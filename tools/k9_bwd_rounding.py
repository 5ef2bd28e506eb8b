#!/usr/bin/env python3
"""How K9's backward rounds, emulated on the CPU: why the kernel splits P
and dS into two bf16 values, and why it sums Dr = rowsum(P o dP) itself.

    PYTHONPATH=src python3 tools/k9_bwd_rounding.py

For bf16 q, k, v, dO at a causal and a non-causal shape (G = 1 and 7 query
heads a kv head, S = 1,024, D = 128), the gradient is evaluated in float64
(the exact reference), by the plain version (f32 sums, one rounding of each
result to bf16), and by three emulations of a kernel's roundings:
  one_bf16   P and dS rounded to one bf16 before their products, Dr from
             the exact output rounded to bf16 (rowsum(dO o O));
  split      P and dS as hi + lo bf16 pairs, Dr as above;
  split_fwd  the pairs, Dr from a forward's output that rounded P to bf16
             before P V (as K9's forward does).
Printed: each emulation's largest error over the plain version's, per
gradient; the card's test holds the kernel to 2 (twice the plain
version's own error). The kernel does what none of these does last: Dr
summed from P and dP, so no output rounding reaches dS."""
from __future__ import annotations

import math

import torch

BF = torch.bfloat16
F64 = torch.float64


def _r(x):
    return x.to(BF).to(x.dtype)


def _split(x):
    hi = _r(x)
    return hi + _r(x - hi)


def grads(q, k, v, do, causal, dt, p_round=None, ds_round=None, o_for_d=None):
    g = q.shape[1] // k.shape[1]
    s_ = q.shape[2]
    scale = 1.0 / math.sqrt(q.shape[3])
    Q, dO = q.to(dt), do.to(dt)
    K = k.to(dt).repeat_interleave(g, 1)
    V = v.to(dt).repeat_interleave(g, 1)
    s = Q @ K.transpose(-1, -2) * scale
    if causal:
        s = s.masked_fill(~torch.ones(s_, s_, dtype=torch.bool).tril(), -1e30)
    p = torch.softmax(s, -1)
    o = p @ V if o_for_d is None else o_for_d(p, V)
    dp = dO @ V.transpose(-1, -2)
    d = (dO * o).sum(-1, keepdim=True)
    ds = p * (dp - d)
    pr = p if p_round is None else p_round(p)
    dsr = ds if ds_round is None else ds_round(ds)
    dq = dsr @ K * scale
    dk = (dsr.transpose(-1, -2) @ Q * scale)
    dv = pr.transpose(-1, -2) @ dO
    b, h, _, dd = dk.shape
    fold = lambda x: x.reshape(b, h // g, g, x.shape[2], dd).sum(2)  # noqa
    return dq, fold(dk), fold(dv)


def main():
    torch.manual_seed(0)
    bf_out = lambda p, V: _r(p @ V)                                 # noqa
    fwd_out = lambda p, V: _r(_r(p) @ V)                            # noqa
    for g in (1, 7):
        for causal in (True, False):
            q = torch.randn(1, g, 1024, 128).to(BF)
            do = torch.randn(1, g, 1024, 128).to(BF)
            k = torch.randn(1, 1, 1024, 128).to(BF)
            v = torch.randn(1, 1, 1024, 128).to(BF)
            exact = grads(q, k, v, do, causal, F64)
            plain = [x.to(BF) for x in grads(q, k, v, do, causal,
                                              torch.float32)]
            base = [float((a.double() - e).abs().max())
                    for a, e in zip(plain, exact)]
            line = [f"G={g} causal={causal}:"]
            for name, kw in (
                    ("one_bf16", dict(p_round=_r, ds_round=_r,
                                      o_for_d=bf_out)),
                    ("split", dict(p_round=_split, ds_round=_split,
                                   o_for_d=bf_out)),
                    ("split_fwd", dict(p_round=_split, ds_round=_split,
                                       o_for_d=fwd_out))):
                got = [x.to(BF) for x in grads(q, k, v, do, causal,
                                                torch.float32, **kw)]
                r = [float((a.double() - e).abs().max()) / b
                     for a, e, b in zip(got, exact, base)]
                line.append(f"{name} dq {r[0]:.2f} dk {r[1]:.2f} "
                            f"dv {r[2]:.2f}")
            print("  ".join(line))


if __name__ == "__main__":
    main()
