#!/usr/bin/env python3
"""K9's backward on the card: the wgmma kernels beside the mma.sync ones.

    python3 tools/k9_bwd_probe.py [--quick] [--parent DIR] [--compare [DIR...]]

Builds the port's kernels and prints nvcc's register, shared-memory and
spill lines for ``csrc/flash_attention_bwd_wgmma.cu``. Then, each part in a
child process under a time limit:

- ``small``: the bf16 backward at D = 64, 128, 256 (the wgmma kernels) and
  96, 192 (mma.sync) over causal, window, non-causal and cross shapes with
  ragged tiles, G = 1, 4 and 7: dq, dk, dv within
  ``flash_attention.bwd_tolerance`` of the float64 gradient, a second call
  bitwise equal, the device launches those ``bwd_kernel_launches`` names;
- ``shapes`` (not with ``--quick``, which keeps ``small`` and
  ``--parent``): the same checks at ``chip_smoke.
  BWD_SHAPES``' bf16 shapes, and each shape's device ms (calls queued
  behind a device-side sleep, ``chip_smoke.device_ms``) in turns with the
  mma.sync kernels of ``csrc/flash_attention_bwd.cu`` called through their
  C entry on the same inputs: mma.sync, wgmma, wgmma, mma.sync;
- ``--parent``: K9's bf16 forward output with its logsumexp, and the
  backward's dq, dk, dv from them, at the wgmma head dimensions in this
  checkout and in the parent's, bitwise;
- ``--compare [DIR...]``: the bf16 ``BWD_SHAPES``' times of this
  checkout's backward and of each other checkout's (each built under its
  own ``build/``), in turns: this, the others, the others reversed, this
  (``--compare`` alone: this checkout twice). Each child also checks its
  results as ``shapes`` does, and times each shape four ways in turn:
  device ms, CUDA events around 20 calls, a profiled span of 3 calls (the
  kernels' durations and the device's first-start to last-end), device
  ms again.

One JSON line per result, the card's name and power limit first; a part
that fails or runs past its limit ends the run with a non-zero exit.
"""
from __future__ import annotations

import json
import math
import os
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]

SMALL = [  # (B, Hq, Hkv, Sq, Skv, D, causal, window)
    (2, 2, 2, 200, 200, 64, True, 0),
    (2, 8, 2, 300, 300, 128, True, 64),
    (1, 7, 1, 64, 300, 128, False, 0),
    (2, 4, 1, 300, 130, 256, False, 0),
    (1, 14, 2, 260, 260, 256, True, 0),
    (2, 2, 2, 300, 300, 256, True, 100),
    (1, 4, 1, 130, 130, 64, False, 40),
    (2, 4, 4, 200, 200, 96, True, 0),
    (1, 4, 2, 300, 300, 192, True, 64),
]


def _inputs(torch, b, hq, hkv, sq, skv, d, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    bf = torch.bfloat16
    q, do = (torch.randn(b, hq, sq, d, generator=g, device="cuda").to(bf)
             for _ in range(2))
    k, v = (torch.randn(b, hkv, skv, d, generator=g, device="cuda").to(bf)
            for _ in range(2))
    return q, k, v, do


def _check(fa, torch, shape, seed):
    b, hq, hkv, sq, skv, d, causal, window = shape
    q, k, v, do = _inputs(torch, b, hq, hkv, sq, skv, d, seed)
    kw = dict(causal=causal, window=window)
    _, lse = fa.flash_attention_fwd(q, k, v, return_lse=True, **kw)
    fa.bwd_device_launches(reset=True)
    got = fa.flash_attention_bwd(q, k, v, lse, do, **kw)
    torch.cuda.synchronize()
    ran = fa.bwd_device_launches(reset=True)
    want = fa.bwd_kernel_launches(torch.bfloat16, d, hq // hkv)
    again = fa.flash_attention_bwd(q, k, v, lse, do, **kw)
    same = all(torch.equal(x, y) for x, y in zip(got, again))
    exact, tol = fa.bwd_tolerance(q, k, v, do, **kw)
    errs = [float((x.double() - e).abs().max()) for x, e in zip(got, exact)]
    ok = same and ran == want and all(e <= t for e, t in zip(errs, tol))
    return {"shape": shape, "kernel": fa.bwd_kernel_for(torch.bfloat16, d),
            "ok": ok, "bitwise_again": same, "launches": ran,
            "err": errs, "tol": list(tol),
            "share_of_tol": [e / t if t else 0.0 for e, t in zip(errs, tol)]}, \
        (q, k, v, do, lse)


def _mma_sync_call(fa, torch, q, k, v, do, lse, causal, window):
    """The mma.sync kernels (csrc/flash_attention_bwd.cu) on the same
    inputs, through their C entry."""
    from repro_torch.kernels import _build
    b, hq, s, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    dsum = torch.empty_like(lse)
    rc = _build.library().repro_flash_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), dsum.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), b, hq, hkv, s, skv, d, int(causal),
        fa._window(window, s), 1.0 / math.sqrt(d), 1, _build.stream())
    _build.check(rc, "flash_attention_bwd (mma.sync)")
    return dq, dk, dv


def part_small(fa, torch):
    for i, shape in enumerate(SMALL):
        res, _ = _check(fa, torch, shape, 100 + i)
        print(json.dumps({"part": "small", **res}), flush=True)
        if not res["ok"]:
            return 1
    return 0


def part_shapes(fa, torch):
    import chip_smoke as cs
    rc = 0
    for label, b, hq, hkv, sq, skv, d, dtype, causal, window in \
            cs.BWD_SHAPES:
        if dtype != "bfloat16":
            continue
        shape = (b, hq, hkv, sq, skv, d, causal, window)
        res, (q, k, v, do, lse) = _check(fa, torch, shape, sq + skv + d)
        new = lambda: fa.flash_attention_bwd(  # noqa: E731
            q, k, v, lse, do, causal=causal, window=window)
        old = lambda: _mma_sync_call(  # noqa: E731
            fa, torch, q, k, v, do, lse, causal, window)
        torch.cuda.empty_cache()
        turns = [("mma_sync", old), ("wgmma", new), ("wgmma", new),
                 ("mma_sync", old)]
        ms = {"mma_sync": [], "wgmma": []}
        for name, fn in turns:
            ms[name].append(cs.device_ms(fn, 5))
        pairs = cs._bwd_pairs(sq, skv, causal, window) * hq * b
        res.update(label=label, device_ms=ms,
                   bound_ms_5_products=5 * 2 * d * pairs /
                   cs.H100_BF16_OPS_PER_S * 1e3,
                   ms_12_products=12 * 2 * d * pairs /
                   cs.H100_BF16_OPS_PER_S * 1e3)
        print(json.dumps({"part": "shapes", **res}), flush=True)
        rc |= not res["ok"]
        del q, k, v, do, lse
        torch.cuda.empty_cache()
    return rc


FWD_SHAPES = [(2, 8, 2, 300, 300, 64, True, 0),
              (1, 28, 4, 1024, 1024, 128, True, 0),
              (1, 4, 1, 700, 700, 256, True, 256),
              (4, 8, 8, 64, 1500, 64, False, 0)]


def _profiled_span_ms(fa, torch, fn, calls: int = 3) -> dict:
    """``calls`` calls under ``torch.profiler``: the backward kernels'
    summed durations and the device's span over them (first kernel's start
    to last kernel's end), each over ``calls``."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    ranges = [e.time_range for e in prof.events()
              if any(n in e.name for n in fa.BWD_KERNELS) and
              str(getattr(e, "device_type", "")).endswith("CUDA")]
    return {"kernels_ms": sum(r.end - r.start for r in ranges) / calls / 1e3,
            "span_ms": (max(r.end for r in ranges) -
                        min(r.start for r in ranges)) / calls / 1e3}


def part_time(fa, torch):
    """The bf16 BWD_SHAPES: the checks of ``_check``; then, in this order,
    the device ms (5 calls behind a device-side sleep), CUDA events around
    20 back-to-back calls, a profiled span of 3 calls, and the device ms
    again."""
    import chip_smoke as cs
    rc = 0
    for label, b, hq, hkv, sq, skv, d, dtype, causal, window in \
            cs.BWD_SHAPES:
        if dtype != "bfloat16":
            continue
        shape = (b, hq, hkv, sq, skv, d, causal, window)
        res, (q, k, v, do, lse) = _check(fa, torch, shape, sq + skv + d)
        torch.cuda.empty_cache()
        fn = lambda: fa.flash_attention_bwd(  # noqa: E731
            q, k, v, lse, do, causal=causal, window=window)
        ms = cs.device_ms(fn, 5)
        events = cs.cuda_ms(fn, 20)
        prof = _profiled_span_ms(fa, torch, fn)
        print(json.dumps({"part": "time", "label": label, "ok": res["ok"],
                          "device_ms": ms, "events_20_ms": events,
                          "profiled": prof,
                          "device_ms_after": cs.device_ms(fn, 5)}),
              flush=True)
        rc |= not res["ok"]
        del q, k, v, do, lse
        torch.cuda.empty_cache()
    return rc


def part_fwd_dump(fa, torch, path):
    """The bf16 forward (output, logsumexp) and the backward's (dq, dk, dv)
    at ``FWD_SHAPES``, saved to ``path``."""
    outs = []
    for i, (b, hq, hkv, sq, skv, d, causal, window) in enumerate(FWD_SHAPES):
        q, k, v, do = _inputs(torch, b, hq, hkv, sq, skv, d, 7 + i)
        o, lse = fa.flash_attention_fwd(q, k, v, causal=causal,
                                        window=window, return_lse=True)
        grads = fa.flash_attention_bwd(q, k, v, lse, do, causal=causal,
                                       window=window)
        outs.append((o.cpu(), lse.cpu(), *(g.cpu() for g in grads)))
    torch.save(outs, path)
    return 0


def child(part: str, src: str, extra: list) -> int:
    sys.path.insert(0, src)
    sys.path.insert(0, str(ROOT))
    import torch
    from repro_torch.kernels import flash_attention as fa
    if part == "small":
        return part_small(fa, torch)
    if part == "shapes":
        return part_shapes(fa, torch)
    if part == "time":
        return part_time(fa, torch)
    return part_fwd_dump(fa, torch, extra[0])


def run_child(args: list, timeout: int) -> int:
    try:
        out = subprocess.run([sys.executable, __file__, *args],
                             timeout=timeout, text=True, capture_output=True)
    except subprocess.TimeoutExpired:
        print(json.dumps({"part": args[1], "error": f"past {timeout} s"}),
              flush=True)
        return 1
    sys.stdout.write(out.stdout)
    if out.returncode:
        sys.stderr.write(out.stderr[-4000:])
    return out.returncode


def main() -> int:
    import argparse
    import torch
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--parent", type=pathlib.Path)
    ap.add_argument("--compare", type=pathlib.Path, nargs="*")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k9_bwd_probe: no CUDA device visible", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build
    so = _build.BUILD_DIR / f"librepro_torch_kernels-{_build._digest()}.so"
    if not so.exists():
        nvcc = _build._nvcc()
        src = _build.CSRC / "flash_attention_bwd_wgmma.cu"
        rep = subprocess.run([nvcc, *_build.NVCC_FLAGS, "-c", str(src), "-o",
                              os.devnull], capture_output=True, text=True)
        for line in (rep.stdout + rep.stderr).splitlines():
            if any(w in line for w in ("registers", "spill", "Compiling",
                                       "error", "warning", "smem")):
                print(line, flush=True)
        if rep.returncode:
            return 1
    _build.build()
    rc = run_child(["child", "small", str(ROOT / "src")], 300)
    if rc:
        return rc
    if not args.quick:
        rc = run_child(["child", "shapes", str(ROOT / "src")], 600)
    others = [t.resolve() for t in args.compare or []]
    turns = [] if args.compare is None else [ROOT, *others, *others[::-1],
                                             ROOT]
    for tree in turns:
        print(json.dumps({"part": "compare", "tree": str(tree)}), flush=True)
        rc |= run_child(["child", "time", str(tree / "src")], 900)
    if args.parent is not None:
        dumps = []
        for tree in (args.parent.resolve(), ROOT):
            path = ROOT / "build" / f"k9_fwd_{len(dumps)}.pt"
            rc |= run_child(["child", "fwd", str(tree / "src"), str(path)],
                            600)
            dumps.append(torch.load(path))
        fwd = all(torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
                  for a, b in zip(*dumps))
        bwd = all(all(torch.equal(x, y) for x, y in zip(a[2:], b[2:]))
                  for a, b in zip(*dumps))
        print(json.dumps({"part": "bitwise_to_parent", "shapes": FWD_SHAPES,
                          "forward_equal": fwd, "backward_equal": bwd}),
              flush=True)
        rc |= not (fwd and bwd)
    return rc


if __name__ == "__main__":
    if sys.argv[1:2] == ["child"]:
        sys.exit(child(sys.argv[2], sys.argv[3], sys.argv[4:]))
    sys.exit(main())
