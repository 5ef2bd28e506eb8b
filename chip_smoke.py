#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port starts and is right on one GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/csrc`` (nvcc, sm_90a),
holds each kernel against its plain torch version on the card at the main
path's shapes, drives the main path — ``Simulator.from_config(cfg).run(k)``
at the full width of ``CONFIG`` (65,536 neurons, S=32) with both fused
lowerings — checks the kernels really ran there, repeats the run for bitwise
determinism, and prints one JSON line per phase. The last two lines are the
kernel table and ``{"ok": true, "device": {...}}``. Any failure exits non-zero
before the result line. Imports torch and the port only (no jax, no repro).
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time

H100_BYTES_PER_S = 3.35e12    # HBM3 rate of an H100 SXM (data sheet)
H100_FP32_OPS_PER_S = 67e12   # FP32 rate outside the tensor cores (data sheet)

# operation counts used for the bounds (32-bit integer or float operations)
HASH_OPS = 120        # one Threefry-2x32: 20 rounds of add/rotate/xor + keys
NEURON_OPS = 60       # Box-Muller tail + Izhikevich + calcium + elements
EDGE_OPS = 8          # load, test, rank split, flag/rate load, add
NODE_OPS = 40         # node statistics: 3 divisions, distance, sqrt, exp
GUMBEL_OPS = HASH_OPS + 20

NEAR_TIE_SHARE = 1e-3  # fail above 0.1 % of decisions differing
DEV = "cuda"


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def bound(nbytes: float, ops: float):
    tb = nbytes / H100_BYTES_PER_S * 1e3
    to = ops / H100_FP32_OPS_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


# ---------------------------------------------------------------- phases
def phase_device():
    import torch
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    card = smi[0] if smi else "nvidia-smi gave no answer"
    print(card, flush=True)
    emit({"phase": "device", "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "cuda": torch.version.cuda,
          "torch": torch.__version__, "nvidia_smi": card})
    return card


def phase_build():
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    so = _build.build(verbose=True)
    _build.library()
    emit({"phase": "build", "seconds": round(time.perf_counter() - t0, 3),
          "library": so.name})


def check_k0():
    import torch
    from repro_torch.kernels import hash as chash
    g = torch.Generator(device=DEV).manual_seed(0)
    words = [torch.randint(0, 2 ** 32, (1 << 20,), generator=g,
                           device=DEV, dtype=torch.int64)
             for _ in range(4)]
    got = chash.threefry_words(*words)
    want = chash.threefry2x32(*words)
    bad = int((got[0] != want[0]).sum() + (got[1] != want[1]).sum())
    emit({"phase": "check", "kernel": "K0 threefry2x32", "words": 1 << 21,
          "mismatches": bad})
    if bad:
        fail(f"K0: {bad} threefry words differ from the plain version")


def k1_inputs(cfg, num_ranks: int, rank: int):
    import torch
    from repro_torch.scenarios.populations import table_for
    n, s = cfg.neurons_per_rank, cfg.max_synapses
    g = torch.Generator(device=DEV).manual_seed(1)
    dev = DEV

    def rn(*shape):
        return torch.randn(shape, generator=g, device=dev)

    def ru(*shape):
        return torch.rand(shape, generator=g, device=dev)

    state = (rn(n) * 5 - 60, rn(n) * 2 - 13, ru(n), ru(n) * 2, ru(n) * 2,
             ru(n) < 0.15, torch.zeros(n, device=dev))
    edges = torch.randint(-1, num_ranks * n, (n, s), generator=g, device=dev,
                          dtype=torch.int32)
    table = table_for(cfg, None, n, device=dev)
    rates = ru(num_ranks, n) * 0.2
    izh = (table.izh_a, table.izh_b, table.izh_c, table.izh_d,
           table.growth_rate, table.target_calcium)
    return state, edges, table.synapse_weight, rates, izh


def k1_compare(cfg, num_ranks=4, rank=1, chunk=2):
    """Kernel vs plain version on one full window, then step-synced if the
    windows differ (every flip must be a near-tie of the threshold)."""
    import torch
    from repro_torch.kernels import activity_fused as af
    state, edges, w, rates, izh = k1_inputs(cfg, num_ranks, rank)
    kw = dict(seed=cfg.seed, num_steps=cfg.rate_period, izh=izh,
              ca_consts=(cfg.calcium_decay, cfg.calcium_beta))
    args = (edges, w, rates, cfg.background_mean, cfg.background_std)
    kst, kspk = af.activity_window(state, *args, chunk, rank, **kw)
    pst, pspk = af.window_plain(state, *args, chunk, rank, **kw)
    torch.cuda.synchronize()
    exact = all(torch.equal(a, b) for a, b in zip(kst, pst)) and \
        torch.equal(kspk, pspk)
    near_ties = worst_rel = max_abs = 0.0
    first_flip = None
    if not exact:
        # step-synced: from the plain state, one kernel step and one plain
        # step; flags may differ only where v sat within 1e-3 of 30
        st = state
        n = cfg.neurons_per_rank
        for t in range(cfg.rate_period):
            one = dict(kw, num_steps=1)
            a, _ = af.activity_window(st, *args, chunk * cfg.rate_period + t,
                                      rank, **one)
            b, _ = af.window_plain(st, *args, chunk * cfg.rate_period + t,
                                   rank, **one)
            flip = a[5] != b[5]
            if bool(flip.any()):
                first_flip = t if first_flip is None else first_flip
                v_other = torch.where(a[5], b[0], a[0])[flip]
                if bool(((v_other - 30.0).abs() >= 1e-3).any()):
                    fail(f"K1: spike flags differ at step {t} away from a "
                         f"near-tie")
                near_ties += int(flip.sum())
            same = ~flip
            for x, y in zip(a[:5], b[:5]):
                err = (x - y).abs()[same]
                rel = (err / y.abs()[same].clamp_min(1.0)).max()
                worst_rel = max(worst_rel, float(rel))
                max_abs = max(max_abs, float(err.max()))
            st = b
        if near_ties > NEAR_TIE_SHARE * n * cfg.rate_period:
            fail(f"K1: {near_ties} near-tie flips")
        if worst_rel > 1e-5:
            fail(f"K1: floats differ by {worst_rel} relative")
    remote = int(((edges >= 0) & (edges // cfg.neurons_per_rank != rank))
                 .sum())
    res = {"exact": exact, "near_tie_flips": near_ties,
           "first_flip_step": first_flip, "max_rel_err": worst_rel,
           "max_abs_err": max_abs,
           "remote_edges": remote}
    emit({"phase": "check", "kernel": "K1 activity_window",
          "shape": {"n": cfg.neurons_per_rank, "S": cfg.max_synapses,
                    "R": num_ranks, "rank": rank, "steps": cfg.rate_period},
          "tolerance": "ints equal except near-ties |v-30|<1e-3 "
                       "(<=0.1%); floats rel 1e-5", **res})
    return res


def k1_timing(cfg, rates_ranks: int, rank: int):
    """Times at the main path's shapes (R=1: every edge local)."""
    from repro_torch.kernels import activity_fused as af
    state, edges, w, rates, izh = k1_inputs(cfg, rates_ranks, rank)
    kw = dict(seed=cfg.seed, num_steps=cfg.rate_period, izh=izh,
              ca_consts=(cfg.calcium_decay, cfg.calcium_beta))
    args = (state, edges, w, rates, cfg.background_mean, cfg.background_std,
            0, rank)
    ms = cuda_ms(lambda: af.activity_window(*args, **kw), reps=5)
    plain_ms = cuda_ms(lambda: af.window_plain(*args, **kw), reps=1)
    n, s, steps = cfg.neurons_per_rank, cfg.max_synapses, cfg.rate_period
    valid = int((edges >= 0).sum())
    remote = int(((edges >= 0) & (edges // n != rank)).sum())
    nbytes = (25 * n + 4 * n * s + 4 * n + 4 * rates.numel() + 8 * n
              + 24 * n + 25 * n + 4 * steps)
    ops = steps * (n * (HASH_OPS + NEURON_OPS) + valid * EDGE_OPS
                   + remote * HASH_OPS)
    return ms, plain_ms, bound(nbytes, ops)


def k2_inputs(cfg):
    import torch
    from repro_torch.connectome import traverse
    from repro_torch.connectome import tree as ctree
    from repro_torch.core import engine
    st = engine.init_state(cfg, 0, 1, device=DEV)
    vac = st.neurons.de_elements
    tree = ctree.build_local_tree(st.positions, vac, 0, cfg, 1)
    stacked = traverse.stack_levels(tree.counts, tree.centroids, 0)
    n = cfg.neurons_per_rank
    gids = torch.arange(n, dtype=torch.int32, device=DEV)
    kw = dict(seed=cfg.seed, sizes=stacked.sizes, theta=cfg.theta,
              sigma=cfg.sigma, frontier=cfg.frontier_cap,
              n_levels=cfg.local_levels + 1)
    args = (stacked.counts, stacked.centroids, tree.leaf_members,
            st.positions, vac, st.positions, torch.zeros_like(gids), gids,
            torch.ones(n, dtype=torch.bool, device=DEV), 0, 0)
    return args, kw


def k2_compare_and_time(cfg):
    from repro_torch.connectome.traverse import phase_b_core
    from repro_torch.kernels import bh_traverse as bt
    args, kw = k2_inputs(cfg)
    kt, kok, kd = bt.bh_traverse(*args, **kw)
    pt, pok, pd = phase_b_core(*args, **kw)
    q = kt.shape[0]
    diff_t = int((kt != pt).sum())
    diff_d = int((kd != pd).sum())
    max_abs = float(max((kt - pt).abs().max(), (kd - pd).abs().max()))
    emit({"phase": "check", "kernel": "K2 bh_traverse",
          "shape": {"Q": q, "L": int(args[0].shape[0]),
                    "C": int(args[0].shape[1]),
                    "M": int(args[2].shape[1]), "F": cfg.frontier_cap},
          "tolerance": "target_gid and depth equal except near-ties "
                       "(<=0.1% of queries)",
          "target_mismatches": diff_t, "depth_mismatches": diff_d,
          "ok_mismatches": int((kok != pok).sum()),
          "found": int(kok.sum())})
    if max(diff_t, diff_d) > NEAR_TIE_SHARE * q:
        fail(f"K2: {diff_t} targets / {diff_d} depths differ")
    ms = cuda_ms(lambda: bt.bh_traverse(*args, **kw), reps=5)
    plain_ms = cuda_ms(lambda: phase_b_core(*args, **kw), reps=1)
    n_levels = kw["n_levels"]
    rounds = int(kd.sum())
    m = int(args[2].shape[1])
    # at least the 8 children per expansion sub-round and 8 sampled entries
    ops = rounds * (n_levels * 8 * NODE_OPS + 8 * (NODE_OPS + GUMBEL_OPS)) \
        + q * m * (NODE_OPS + GUMBEL_OPS)
    nbytes = sum(a.numel() * a.element_size() for a in args[:9]) + q * 9
    return ms, plain_ms, bound(nbytes, ops), max(diff_t, diff_d), max_abs


def run_main_path(cfg, chunks: int):
    import torch
    from repro_torch.kernels import _build
    from repro_torch.sim.api import Simulator
    sim = Simulator.from_config(cfg, device=DEV)
    sim.init()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sim.step()                                    # warm-up chunk
    torch.cuda.synchronize()
    warm = (time.perf_counter() - t0) * 1e3
    per_chunk = []
    for _ in range(chunks):
        t0 = time.perf_counter()
        sim.run(1)
        torch.cuda.synchronize()
        per_chunk.append((time.perf_counter() - t0) * 1e3)
    return sim, warm, per_chunk, _build.launch_counts()


def phase_profile(sim, card):
    """One more chunk under torch.profiler. From the exported Chrome trace
    (build/chip_smoke_trace.json): the device busy time (kernels,
    copies, memsets) against the chunk's wall time, the device time inside
    each phase range, and the kernels that take the most device time. The
    profiler slows the host, so the wall time here is longer than the
    unprofiled chunk's."""
    import collections
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sim.step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "build")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "chip_smoke_trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    dev = [e for e in events
           if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    busy_ms = sum(e["dur"] for e in dev) / 1e3
    ranges = {}
    for r in events:
        if r.get("cat") == "gpu_user_annotation":
            a, b = r["ts"], r["ts"] + r["dur"]
            inside = [e["dur"] for e in dev if a <= e["ts"] < b]
            ranges[r["name"]] = {"span_ms": r["dur"] / 1e3,
                                 "device_ms": sum(inside) / 1e3,
                                 "launches": len(inside)}
    by_name = collections.defaultdict(lambda: [0.0, 0])
    for e in dev:
        by_name[e["name"][:80]][0] += e["dur"] / 1e3
        by_name[e["name"][:80]][1] += 1
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
    emit({"phase": "profile", "card": card, "chunk_wall_ms": wall_ms,
          "device_busy_ms": busy_ms,
          "device_idle_share": (1.0 - busy_ms / wall_ms) if dev else None,
          "ranges": ranges,
          "top_device": [{"name": k, "ms": v[0], "launches": v[1]}
                         for k, v in top]})


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible; this script needs one "
              "NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "src"))
    try:
        from repro_torch.configs.msp_brain import CONFIG, SMOKE_CONFIG
        from repro_torch.kernels import _build
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script ({e})",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    card = phase_device()
    phase_build()
    slice_cfg = dataclasses.replace(CONFIG, activity_impl="fused",
                                    connectivity_impl="fused")

    # ---- kernels against their plain versions --------------------------
    check_k0()
    k1 = k1_compare(slice_cfg)
    k1_ms, k1_plain, (k1_bound, k1_by) = k1_timing(slice_cfg, 1, 0)
    k2_ms, k2_plain, (k2_bound, k2_by), k2_err, k2_abs = \
        k2_compare_and_time(slice_cfg)
    emit({"phase": "kernel_times", "card": card, "K1_ms": k1_ms,
          "K1_plain_ms": k1_plain, "K2_ms": k2_ms, "K2_plain_ms": k2_plain})

    # ---- fused == reference on the card, small size --------------------
    small = {}
    for impl in ("reference", "fused"):
        from repro_torch.sim.api import Simulator
        cfg = dataclasses.replace(SMOKE_CONFIG, activity_impl=impl,
                                  connectivity_impl=impl)
        sim = Simulator.from_config(cfg, device=DEV)
        sim.run(3)
        small[impl] = (sim.stats(), sim.state.in_edges.cpu(),
                       sim.state.out_edges.cpu())
    same_small = all(
        small["reference"][0][k] == small["fused"][0][k]
        for k in small["reference"][0] if not k.startswith("launches/")) \
        and torch.equal(small["reference"][1], small["fused"][1]) \
        and torch.equal(small["reference"][2], small["fused"][2])
    emit({"phase": "fused_vs_reference", "config": "SMOKE_CONFIG",
          "chunks": 3, "equal": same_small})
    if not same_small and k1["exact"] and k2_err == 0:
        fail("fused and reference lowerings disagree on SMOKE_CONFIG")

    # ---- the main path --------------------------------------------------
    chunks = 5
    _build.reset_launch_counts()
    sim, warm, per_chunk, counts = run_main_path(slice_cfg, chunks)
    stats, health = sim.stats(), sim.health()
    st = sim.state
    n = slice_cfg.neurons_per_rank
    finite = all(bool(torch.isfinite(x).all()) for x in (
        st.neurons.v, st.neurons.u, st.neurons.calcium, st.neurons.rate,
        st.positions))
    shapes_ok = (tuple(st.in_edges.shape) == (n, slice_cfg.max_synapses)
                 and tuple(st.neurons.v.shape) == (n,))
    keys = ("synapses_formed", "synapses_deleted", "activity_spikes",
            "bh_restarts", "bh_requests", "activity_steps")
    emit({"phase": "main_path", "config": "CONFIG + activity_impl/"
          "connectivity_impl='fused'", "neurons": n,
          "S": slice_cfg.max_synapses, "chunks": chunks + 1,
          "warmup_chunk_ms": warm, "chunk_ms": per_chunk,
          "median_chunk_ms": sorted(per_chunk)[len(per_chunk) // 2],
          "launches": counts, "health": health,
          "counters": {k: stats[k] for k in keys}, "finite": finite,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
    if counts["activity_window"] != (chunks + 1) * slice_cfg.rate_period:
        fail(f"K1 launched {counts['activity_window']} times")
    if counts["bh_traverse"] < chunks + 1:
        fail(f"K2 launched {counts['bh_traverse']} times")
    if health["health_flags"] != 0 or not finite or not shapes_ok:
        fail(f"main path unhealthy: {health}, finite={finite}")
    if stats["synapses_formed"] <= 0 or stats["activity_spikes"] <= 0:
        fail("main path formed no synapses or fired no spikes")

    # ---- determinism ----------------------------------------------------
    sim2, _, _, _ = run_main_path(slice_cfg, chunks)
    same = (torch.equal(sim.state.in_edges, sim2.state.in_edges)
            and torch.equal(sim.state.out_edges, sim2.state.out_edges)
            and all(sim2.stats()[k] == stats[k] for k in keys))
    emit({"phase": "determinism", "equal": same})
    if not same:
        fail("a second run from the same seed differs")
    phase_profile(sim2, card)

    kernels = [
        {"name": "activity_window", "route": "cuda",
         "source": "src/repro_torch/csrc/activity_window.cu",
         "replaces": "src/repro/kernels/activity_fused.py:279",
         "launches": counts["activity_window"],
         "max_abs_err": k1["max_abs_err"],
         "ms": k1_ms, "plain_ms": k1_plain, "bound_ms": k1_bound,
         "bound_by": k1_by, "library_ms": None},
        {"name": "bh_traverse", "route": "cuda",
         "source": "src/repro_torch/csrc/bh_traverse.cu",
         "replaces": "src/repro/kernels/bh_traverse.py:77",
         "launches": counts["bh_traverse"], "max_abs_err": k2_abs,
         "ms": k2_ms, "plain_ms": k2_plain, "bound_ms": k2_bound,
         "bound_by": k2_by, "library_ms": None},
    ]
    emit({"phase": "done", "seconds": time.perf_counter() - t_start,
          "card": card})
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
