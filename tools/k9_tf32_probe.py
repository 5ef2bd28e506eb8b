#!/usr/bin/env python3
"""K9 in f32 on the card: the TF32 kernels (three products to the product)
beside the FFMA kernels they replace at D = 64 and 128.

    python3 tools/k9_tf32_probe.py [--quick] [--compare DIR...]

Builds the port's kernels and prints nvcc's register, shared-memory and
spill lines for ``csrc/flash_attention_tf32.cu``. Then, each part in a child
process under a time limit:

- ``small``: the f32 forward and backward at D = 64 and 128 over causal,
  window, non-causal and cross shapes with ragged tiles, G = 1, 4, 7 and
  10: the forward within 2e-5 (absolute + relative) of
  ``flash_attention_plain``, dq, dk, dv within
  ``flash_attention.bwd_tolerance`` of the float64 gradient, each error also
  as a share of its tolerance; a second call bitwise equal; the device
  launches those ``kernel_launches`` / ``bwd_kernel_launches`` name;
- ``time`` (not with ``--quick``): at qwen2-7b's heads (B = 1, 28 / 4 x
  128, causal; the forward at S = 4,096, the backward at S = 1,024) and at
  whisper-base's encoder (B = 16, 8 x 64, S = 1,500, non-causal), the same
  checks, then the device ms (calls queued behind a device-side sleep,
  ``chip_smoke.device_ms``) in turns with the FFMA kernels called through
  their C entries on the same inputs (FFMA, TF32, TF32, FFMA), SDPA's f32
  call beside, each TF32 kernel's device ms from a profiled call, and the
  bounds: the f32 products at the TF32 rate three times over, and at the
  FFMA rate;
- ``--compare DIR...``: the ``time`` shapes' TF32 device ms of this
  checkout and of each other checkout (each built under its own
  ``build/``), in turns: this, the others, the others reversed, this.

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
    (2, 4, 1, 300, 130, 64, False, 0),
    (1, 14, 2, 260, 260, 128, True, 0),
    (1, 4, 1, 130, 130, 64, False, 40),
    (2, 10, 1, 127, 129, 128, True, 0),
    (1, 2, 2, 1000, 1000, 128, True, 0),
]
TIME = [  # (label, B, Hq, Hkv, S, D, causal)
    ("qwen2-7b f32 forward", 1, 28, 4, 4096, 128, True),
    ("qwen2-7b f32 backward", 1, 28, 4, 1024, 128, True),
    ("whisper-base encoder f32", 16, 8, 8, 1500, 64, False),
]
TF32_RATE = 495e12    # dense TF32 tensor-core rate (data sheet)
FFMA_RATE = 67e12


def _inputs(torch, b, hq, hkv, sq, skv, d, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    q, do = (torch.randn(b, hq, sq, d, generator=g, device="cuda")
             for _ in range(2))
    k, v = (torch.randn(b, hkv, skv, d, generator=g, device="cuda")
            for _ in range(2))
    return q, k, v, do


def _check(fa, torch, shape, seed, bwd=True):
    """The forward's and (``bwd``) the backward's checks at one shape."""
    b, hq, hkv, sq, skv, d, causal, window = shape
    q, k, v, do = _inputs(torch, b, hq, hkv, sq, skv, d, seed)
    kw = dict(causal=causal, window=window)
    f32 = torch.float32
    fa.device_launches(reset=True)
    out, lse = fa.flash_attention_fwd(q, k, v, return_lse=True, **kw)
    torch.cuda.synchronize()
    ran_f = fa.device_launches(reset=True)
    plain = fa.flash_attention_plain(q, k, v, **kw)
    fwd_share = float(((out - plain).abs() /
                       (2e-5 + 2e-5 * plain.abs())).max())
    again = fa.flash_attention_fwd(q, k, v, return_lse=True, **kw)
    same_f = torch.equal(out, again[0]) and torch.equal(lse, again[1])
    res = {"shape": shape, "kernel": fa.kernel_for(f32, d),
           "fwd_launches": ran_f, "fwd_err": float((out - plain).abs().max()),
           "fwd_share_of_2e-5": fwd_share, "fwd_bitwise_again": same_f}
    ok = same_f and fwd_share <= 1.0 and ran_f == fa.kernel_launches(f32, d)
    del plain, again
    if bwd:
        fa.bwd_device_launches(reset=True)
        got = fa.flash_attention_bwd(q, k, v, lse, do, **kw)
        torch.cuda.synchronize()
        ran = fa.bwd_device_launches(reset=True)
        want = fa.bwd_kernel_launches(f32, d, hq // hkv)
        again = fa.flash_attention_bwd(q, k, v, lse, do, **kw)
        same = all(torch.equal(x, y) for x, y in zip(got, again))
        exact, tol = fa.bwd_tolerance(q, k, v, do, **kw)
        errs = [float((x.double() - e).abs().max())
                for x, e in zip(got, exact)]
        ok = ok and same and ran == want and \
            all(e <= t for e, t in zip(errs, tol))

        def share(grads):
            return [float((x.double() - e).abs().max()) / t if t else 0.0
                    for x, e, t in zip(grads, exact, tol)]
        # the same inputs through the FFMA kernels (fed their own forward's
        # logsumexp), and through the TF32 kernels fed the float64
        # logsumexp rounded once to f32
        _, lse_ffma = _ffma_fwd(fa, torch, q, k, v, causal, window)
        lse_exact = fa.lse_plain(*(t.double() for t in (q, k)), **kw).float()
        res.update(bwd_launches=ran, bwd_bitwise_again=same, err=errs,
                   tol=list(tol), share_of_tol=share(got),
                   ffma_share_of_tol=share(_ffma_bwd(
                       fa, torch, q, k, v, do, lse_ffma, causal, window)),
                   share_with_exact_lse=share(fa.flash_attention_bwd(
                       q, k, v, lse_exact, do, **kw)))
    res["ok"] = ok
    return res, (q, k, v, do, lse)


def _ffma_fwd(fa, torch, q, k, v, causal, window=0):
    """flash_f32 (csrc/flash_attention.cu) through its C entry: (out,
    lse)."""
    from repro_torch.kernels import _build
    b, hq, s, d = q.shape
    o = torch.empty_like(q)
    lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    rc = _build.library().repro_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), b, hq, k.shape[1], s, k.shape[2], d, int(causal),
        fa._window(window, s), 1.0 / math.sqrt(d), 0, _build.stream())
    _build.check(rc, "flash_attention (FFMA)")
    return o, lse


def _ffma_bwd(fa, torch, q, k, v, do, lse, causal, window=0):
    """dq_f32 and dkdv_f32 (csrc/flash_attention_bwd.cu) through their C
    entry."""
    from repro_torch.kernels import _build
    b, hq, s, d = q.shape
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    dsum = torch.empty_like(lse)
    rc = _build.library().repro_flash_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), dsum.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), b, hq, k.shape[1], s, k.shape[2], d, int(causal),
        fa._window(window, s), 1.0 / math.sqrt(d), 0, _build.stream())
    _build.check(rc, "flash_attention_bwd (FFMA)")
    return dq, dk, dv


def _sdpa_fwd(torch, q, k, v, causal):
    import torch.nn.functional as F
    return F.scaled_dot_product_attention(q, k, v, is_causal=causal,
                                          enable_gqa=q.shape[1] != k.shape[1])


def _split_ms(fa, torch, fn, names, calls=3):
    """Each named kernel's device ms a call from a profiled run of
    ``calls`` calls."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    ms = {}
    for e in prof.key_averages():
        t = getattr(e, "device_time_total", None)
        if t is None:
            t = e.cuda_time_total
        for name in names:
            if name in e.key:
                ms[name] = ms.get(name, 0.0) + t / calls / 1e3
    return ms


def part_small(fa, torch):
    for i, shape in enumerate(SMALL):
        res, _ = _check(fa, torch, shape, 100 + i)
        print(json.dumps({"part": "small", **res}), flush=True)
        if not res["ok"]:
            return 1
    return 0


def part_time(fa, torch):
    import chip_smoke as cs
    rc = 0
    for label, b, hq, hkv, s, d, causal in TIME:
        bwd = "forward" not in label
        shape = (b, hq, hkv, s, s, d, causal, 0)
        res, (q, k, v, do, lse) = _check(fa, torch, shape, s + d, bwd=bwd)
        torch.cuda.empty_cache()
        pairs = (cs.attention_pairs(s, s, 0) if causal else s * s) * hq * b
        if bwd:
            new = lambda: fa.flash_attention_bwd(  # noqa: E731
                q, k, v, lse, do, causal=causal)
            old = lambda: _ffma_bwd(  # noqa: E731
                fa, torch, q, k, v, do, lse, causal)
            flops, names = 5 * 2 * d * pairs, fa.BWD_KERNELS
            lib = cs._sdpa_bwd_ms(q, k, v, do, causal, 0)
        else:
            new = lambda: fa.flash_attention_fwd(  # noqa: E731
                q, k, v, causal=causal)
            old = lambda: _ffma_fwd(fa, torch, q, k, v, causal)  # noqa
            flops, names = 4 * d * pairs, fa.KERNELS
            lib = cs.device_ms(lambda: _sdpa_fwd(torch, q, k, v, causal), 5)
        ms = {"ffma": [], "tf32x3": []}
        for name, fn in (("ffma", old), ("tf32x3", new), ("tf32x3", new),
                         ("ffma", old)):
            ms[name].append(cs.device_ms(fn, 5))
        res.update(label=label, device_ms=ms, sdpa_f32_ms=lib,
                   kernels_ms=_split_ms(fa, torch, new, names),
                   bound_ms_tf32x3=3 * flops / TF32_RATE * 1e3,
                   bound_ms_ffma=flops / FFMA_RATE * 1e3)
        print(json.dumps({"part": "time", **res}), flush=True)
        rc |= not res["ok"]
        del q, k, v, do, lse
        torch.cuda.empty_cache()
    return rc


def part_turn(fa, torch, tree):
    """The ``time`` shapes' TF32 device ms in checkout ``tree``."""
    import chip_smoke as cs
    for label, b, hq, hkv, s, d, causal in TIME:
        q, k, v, do = _inputs(torch, b, hq, hkv, s, s, d, s + d)
        _, lse = fa.flash_attention_fwd(q, k, v, causal=causal,
                                        return_lse=True)
        if "forward" in label:
            fn = lambda: fa.flash_attention_fwd(  # noqa: E731
                q, k, v, causal=causal)
        else:
            fn = lambda: fa.flash_attention_bwd(  # noqa: E731
                q, k, v, lse, do, causal=causal)
        print(json.dumps({"part": "turn", "tree": tree, "label": label,
                          "device_ms": cs.device_ms(fn, 5)}), flush=True)
        del q, k, v, do, lse
        torch.cuda.empty_cache()
    return 0


def child(part: str, src: str) -> int:
    sys.path.insert(0, src)
    sys.path.insert(0, str(ROOT))
    import torch
    from repro_torch.kernels import flash_attention as fa
    if part == "turn":
        return part_turn(fa, torch, str(pathlib.Path(src).parent))
    return part_small(fa, torch) if part == "small" else part_time(fa, torch)


def run_child(part: str, timeout: int, tree: pathlib.Path = ROOT) -> int:
    try:
        out = subprocess.run([sys.executable, __file__, "child", part,
                              str(tree / "src")],
                             timeout=timeout, text=True, capture_output=True)
    except subprocess.TimeoutExpired:
        print(json.dumps({"part": part, "error": f"past {timeout} s"}),
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
    ap.add_argument("--compare", type=pathlib.Path, nargs="*")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k9_tf32_probe: no CUDA device visible", file=sys.stderr)
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
        src = _build.CSRC / "flash_attention_tf32.cu"
        rep = subprocess.run([nvcc, *_build.NVCC_FLAGS, "-c", str(src), "-o",
                              os.devnull], capture_output=True, text=True)
        for line in (rep.stdout + rep.stderr).splitlines():
            if any(w in line for w in ("registers", "spill", "Compiling",
                                       "error", "warning", "smem")):
                print(line, flush=True)
        if rep.returncode:
            return 1
    _build.build()
    rc = run_child("small", 300)
    if args.quick:
        return rc
    if args.compare is not None:
        others = [t.resolve() for t in args.compare]
        for tree in [ROOT, *others, *others[::-1], ROOT]:
            rc |= run_child("turn", 600, tree)
        return rc
    return rc | run_child("time", 600)


if __name__ == "__main__":
    if sys.argv[1:2] == ["child"]:
        sys.exit(child(sys.argv[2], sys.argv[3]))
    sys.exit(main())
