#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port starts and is right on one GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/csrc`` (nvcc, sm_90a),
holds each kernel (K0-K5) against its plain torch version on the card at the
main paths' shapes, drives the public kernel API (``repro_torch.kernels.ops``:
K6 radix argsort, K7 Gaussian probabilities, K8 neuron step, K9 flash
attention) at the widths the repo uses and holds each call against its plain
version, and drives two paths at the full width of ``CONFIG`` (65,536
neurons, S=32):

- the activity + traversal path, ``Simulator.from_config(cfg).run(k)`` with
  ``activity_impl`` and ``connectivity_impl`` fused (K1, K2);
- the scenario path, ``Simulator.from_config(cfg, scenario=lesion_rewiring(),
  device="cuda").run(12, recorder=rec)`` with all five lowerings fused (K1-K5),
  through the lesion at step 1,000.

For the kernel API and each path it checks the kernels really ran there (the
launch counts are set to 0 just before and read just after; for K9, which of
its three kernels each shape took) and that a second run is bitwise equal,
then profiles one chunk of the scenario path, and prints one JSON line per
phase. Every kernel is timed twice: a call (CUDA events around back-to-back
calls) and its device time with the host hidden (the calls queued behind a
device-side sleep). The last two lines are the kernel table and
``{"ok": true, "device": {...}}``. Any failure exits non-zero before the result
line. Imports torch and the port only (no jax, no repro).
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
H100_BF16_OPS_PER_S = 989e12  # dense bf16 tensor-core rate (data sheet)
# INT32: an SM issues 64 INT32 results a clock (half its 128 FP32 lanes;
# Hopper white paper), on 132 SMs at the 1,980 MHz boost clock that also
# gives the FP32 figure (128 x 2 x 132 x 1.98e9 = 67e12): 16.7e12 a second.
# The integer kernels' (K1, K3-K6, and K2's hashing) integer operations are
# counted at this rate, their float operations at the FP32 rate; the two
# pipes issue side by side, so the bound takes the larger time.
H100_INT32_OPS_PER_S = 64 * 132 * 1.98e9

# operation counts used for the bounds (32-bit integer or float operations)
# one Threefry-2x32 (csrc/hash.cuh): 2 initial adds, 20 rounds of add,
# rotate (one funnel shift) and xor, 5 key injections of 2 adds (the key
# schedule is loop-invariant)
HASH_OPS = 2 + 20 * 3 + 5 * 2
NEURON_OPS = 60       # Box-Muller tail + Izhikevich + calcium + elements
# a slot of K1's row a step (rank split and rate are decoded once a window):
# code load, local test, word index, word load, bit shift, bit test
SLOT_OPS = 6
NODE_OPS = 40         # node statistics: 3 divisions, distance, sqrt, exp
GUMBEL_LOG_OPS = 20   # the two logs of a Gumbel draw (float)
MORTON_OPS = 40       # 3 scale+truncate+clamp, 3 bit spreads, rebase, rank
APPLY_OPS = 8         # per table slot or message/request: load, compare, move
ROUTE_OPS = 6         # per flattened entry: load, divide, rank, store
NEURON_STEP_OPS = 30  # two Euler halves, reset, calcium, division, growth
SORT_OPS = 12         # per key and digit pass: digit, rank, scatter
GAUSS_OPS = 30        # 3-lane distance identity, division, exp, weight, sum

# K9 shapes: (label, Hq, Hkv, D, S, window, dtype); B = 1, causal
ATTENTION_SHAPES = (
    ("qwen2-7b bf16", 28, 4, 128, 4096, 0, "bfloat16"),
    ("qwen2-7b f32", 28, 4, 128, 4096, 0, "float32"),
    ("recurrentgemma-2b local bf16", 10, 1, 256, 8192, 2048, "bfloat16"),
)

NEAR_TIE_SHARE = 1e-3  # fail above 0.1 % of decisions differing
SLEEP_CYCLES = 100_000_000  # device-side sleep of device_ms, ~50 ms at 2 GHz
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


def device_ms(fn, reps: int) -> float:
    """Device time per call, the host's work hidden: after a warm-up the
    calls are queued behind a device-side sleep long enough for the host to
    enqueue them all, so the events around them time only the device (the
    kernels and the gaps between their launches). ``cuda_ms`` also sees a
    host that cannot keep the device busy. No profiler: a torch.profiler
    session slows the host's launches for the rest of the process."""
    import torch
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def bound(nbytes: float, int_ops: float = 0.0, fp_ops: float = 0.0,
          fp_ops_per_s: float = H100_FP32_OPS_PER_S):
    """The least time for the work: bytes at the HBM rate, or integer and
    float operations at their own rates (run side by side), whichever is
    longer. Returns (ms, "bytes" or "operations")."""
    tb = nbytes / H100_BYTES_PER_S * 1e3
    to = max(int_ops / H100_INT32_OPS_PER_S, fp_ops / fp_ops_per_s) * 1e3
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


def k1_scenario_tables(cfg, chunk: int):
    """Stimulus and lesion tables over random halves of the neurons whose
    windows open or close inside the window of ``chunk``."""
    import torch
    n, t = cfg.neurons_per_rank, chunk * cfg.rate_period
    g = torch.Generator(device=DEV).manual_seed(5)
    masks = torch.rand(3, n, generator=g, device=DEV) < 0.5
    stim = (masks[:2].to(torch.float32),
            ((4.0, t + 30, t + 70), (-2.0, t - 50, t + 50)))
    lesions = (masks[1:], ((t + 60, 1 << 30), (0, t + 40)))
    return {"stim": stim, "lesions": lesions}


def k1_compare(cfg, num_ranks=4, rank=1, chunk=2, tables=None):
    """Kernel vs plain version on one full window, then step-synced if the
    windows differ (every flip must be a near-tie of the threshold).
    ``tables``: stimulus and lesion operands, or None."""
    import torch
    from repro_torch.kernels import activity_fused as af
    state, edges, w, rates, izh = k1_inputs(cfg, num_ranks, rank)
    kw = dict(seed=cfg.seed, num_steps=cfg.rate_period, izh=izh,
              ca_consts=(cfg.calcium_decay, cfg.calcium_beta),
              **(tables or {}))
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
          "scenario_tables": None if tables is None else {
              "stim": list(tables["stim"][1]),
              "lesions": list(tables["lesions"][1])},
          "tolerance": "ints equal except near-ties |v-30|<1e-3 "
                       "(<=0.1%); floats rel 1e-5", **res})
    return res


def k1_timing(cfg, rates_ranks: int, rank: int, lesions=None):
    """Times of one window at the main path's shapes (R=1: every edge local;
    the scenario path's one lesion window) or with remote edges (R=4, rank
    1), and the kernel's device launches in one call (read from the
    source's counter)."""
    import torch
    from repro_torch.kernels import activity_fused as af
    state, edges, w, rates, izh = k1_inputs(cfg, rates_ranks, rank)
    kw = dict(seed=cfg.seed, num_steps=cfg.rate_period, izh=izh,
              ca_consts=(cfg.calcium_decay, cfg.calcium_beta),
              lesions=lesions)
    args = (state, edges, w, rates, cfg.background_mean, cfg.background_std,
            0, rank)
    af.device_launches(reset=True)
    af.activity_window(*args, **kw)
    torch.cuda.synchronize()
    per_window = af.device_launches(reset=True)
    ms = cuda_ms(lambda: af.activity_window(*args, **kw), reps=5)
    dev_ms = device_ms(lambda: af.activity_window(*args, **kw), 5)
    plain_ms = cuda_ms(lambda: af.window_plain(*args, **kw), reps=1)
    n, s, steps = cfg.neurons_per_rank, cfg.max_synapses, cfg.rate_period
    valid = int((edges >= 0).sum())
    remote = int(((edges >= 0) & (edges // n != rank)).sum())
    nbytes = (25 * n + 4 * n * s + 4 * n + 4 * rates.numel() + 8 * n
              + 24 * n + 25 * n + 4 * steps
              + (0 if lesions is None else lesions[0].numel()))
    # a step: the noise draw a neuron, SLOT_OPS a used slot, and a Threefry
    # draw a remote slot
    int_ops = steps * (n * HASH_OPS + valid * SLOT_OPS + remote * HASH_OPS)
    fp_ops = steps * n * NEURON_OPS
    return ms, dev_ms, plain_ms, bound(nbytes, int_ops, fp_ops), per_window


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
    dev_ms = device_ms(lambda: bt.bh_traverse(*args, **kw), 5)
    plain_ms = cuda_ms(lambda: phase_b_core(*args, **kw), reps=1)
    n_levels = kw["n_levels"]
    rounds = int(kd.sum())
    m = int(args[2].shape[1])
    # at least the 8 children per expansion sub-round and 8 sampled entries,
    # each a Gumbel draw (a Threefry and two logs)
    draws = rounds * 8 + q * m
    int_ops = draws * HASH_OPS
    fp_ops = rounds * n_levels * 8 * NODE_OPS + draws * (NODE_OPS
                                                         + GUMBEL_LOG_OPS)
    nbytes = sum(a.numel() * a.element_size() for a in args[:9]) + q * 9
    return (ms, dev_ms, plain_ms, bound(nbytes, int_ops, fp_ops),
            max(diff_t, diff_d), max_abs)


def _int_diff(got, want) -> float:
    """Largest |kernel - plain| over integer outputs (0 when bit-equal)."""
    return max(float((a.to(float) - b.to(float)).abs().max())
               if a.numel() else 0.0 for a, b in zip(got, want))


def _check_exact(name: str, got, want, shape: dict) -> float:
    import torch
    equal = all(torch.equal(a, b) for a, b in zip(got, want))
    diff = _int_diff(got, want)
    emit({"phase": "check", "kernel": name, "shape": shape,
          "tolerance": "bit-equal", "equal": equal, "max_abs_err": diff})
    if not equal:
        fail(f"{name}: differs from its plain version (max {diff})")
    return diff


def check_k3(cfg):
    """K3 at the main path's shapes: the neurons of CONFIG, the rank's leaf
    block (n_leaf = 8^local_levels)."""
    from repro_torch.connectome import tree as ctree
    from repro_torch.core import engine
    from repro_torch.kernels import radix_sort as rs
    pos = engine.init_state(cfg, 0, 1, device=DEV).positions
    leaf_level, n_leaf, base_cell = ctree._tree_geometry(0, cfg, 1)
    base = base_cell * 8 ** cfg.local_levels
    kw = dict(leaf_level=leaf_level, n_leaf=n_leaf)
    got = rs.morton_sort(pos, base, **kw)
    want = rs.morton_sort_plain(pos, base, **kw)
    n = pos.shape[0]
    diff = _check_exact("K3 morton_sort", got, want,
                        {"n": n, "leaf_level": leaf_level, "n_leaf": n_leaf,
                         "max_slot": int(got[1].max())})
    ms = cuda_ms(lambda: rs.morton_sort(pos, base, **kw), reps=5)
    dev_ms = device_ms(lambda: rs.morton_sort(pos, base, **kw), 5)
    plain_ms = cuda_ms(lambda: rs.morton_sort_plain(pos, base, **kw), reps=1)
    nbytes = n * 3 * 4 + 4 + 2 * n * 4        # the positions in, rel and slot
    return ms, plain_ms, bound(nbytes, n * MORTON_OPS), diff, dev_ms


def _apply_bytes(n, s, qm, qr):
    """synapse_apply.py:107-115: the table in and out, messages, requests,
    vacancies and the accept mask once each."""
    return 2 * n * s * 4 + qm * 9 + qr * 13 + qr + n * 4


def check_k4(cfg):
    """K4's two launch shapes on the scenario path, on random full-width
    inputs: a drain at the lesion's message count (no valid requests) and
    the accept of a full request buffer (no valid messages)."""
    import torch
    from repro_torch.connectome import routing
    from repro_torch.connectome.synapses import compact
    from repro_torch.kernels import synapse_apply as sa
    n, s = cfg.neurons_per_rank, cfg.max_synapses
    g = torch.Generator(device=DEV).manual_seed(6)
    i32 = torch.int32
    edges = torch.randint(0, n, (n, s), generator=g, device=DEV, dtype=i32)
    edges = compact(torch.where(torch.rand(n, s, generator=g, device=DEV)
                                < 0.4, -1, edges))
    qm = routing.cap_deletions(cfg, True)
    qr = routing.cap_requests(cfg, 1)
    live = torch.nonzero(edges >= 0)
    pick = live[torch.randint(0, live.shape[0], (qm,), generator=g,
                              device=DEV)]
    mlid = pick[:, 0].to(i32)
    mgid = edges[pick[:, 0], pick[:, 1]]
    mval = torch.rand(qm, generator=g, device=DEV) < 0.9
    z8 = torch.zeros(8, dtype=i32, device=DEV)
    f8 = torch.zeros(8, dtype=torch.bool, device=DEV)
    drain = (edges, mlid, mgid, mval, z8, z8, f8,
             torch.zeros(8, device=DEV), torch.zeros(n, device=DEV))
    accept = (edges, z8, z8, f8,
              torch.randint(0, n, (qr,), generator=g, device=DEV, dtype=i32),
              torch.randint(0, n, (qr,), generator=g, device=DEV, dtype=i32),
              torch.rand(qr, generator=g, device=DEV) < 0.9,
              torch.rand(qr, generator=g, device=DEV),
              torch.rand(n, generator=g, device=DEV) * 6)
    res = {}
    for name, args, q in (("drain", drain, (qm, 8)),
                          ("accept", accept, (8, qr))):
        sa.device_launches(reset=True)
        got = sa.synapse_apply(*args)
        torch.cuda.synchronize()
        per_call = sa.device_launches(reset=True)
        want = sa.synapse_apply_plain(*args)
        diff = _check_exact(f"K4 synapse_apply ({name})", got, want,
                            {"n": n, "S": s, "qm": q[0], "qr": q[1],
                             "changed_rows": int((got[0] != edges).any(1)
                                                 .sum()),
                             "accepted": int(got[1].sum()),
                             "device_launches_per_call": per_call})
        if per_call != 1:
            fail(f"K4 ({name}): {per_call} device launches in one call")
        ms = cuda_ms(lambda: sa.synapse_apply(*args), reps=5)
        dev_ms = device_ms(lambda: sa.synapse_apply(*args), 5)
        plain_ms = cuda_ms(lambda: sa.synapse_apply_plain(*args), reps=1)
        ops = (n * s + q[0] + q[1]) * APPLY_OPS
        res[name] = (ms, plain_ms, bound(_apply_bytes(n, s, *q), ops), diff,
                     dev_ms, per_call)
    return res


def check_k5(cfg):
    """K5 at the scenario path's shapes: the flattened (n*S,) kill pairs of
    a lesion-sized retraction (half the edges) into the lesion cap, so the
    drop path runs."""
    import torch
    from repro_torch.connectome import routing
    from repro_torch.kernels import synapse_apply as sa
    n, s = cfg.neurons_per_rank, cfg.max_synapses
    g = torch.Generator(device=DEV).manual_seed(7)
    m = n * s
    other = torch.randint(0, n, (m,), generator=g, device=DEV,
                          dtype=torch.int32)
    other = torch.where(torch.rand(m, generator=g, device=DEV) < 0.5, -1,
                        other)
    mine = torch.arange(m, device=DEV, dtype=torch.int32) // s
    cap = routing.cap_deletions(cfg, True)
    kw = dict(n=n, num_ranks=1, cap=cap)
    got = sa.route_build(other, mine, **kw)
    want = sa.route_build_plain(other, mine, **kw)
    diff = _check_exact("K5 route_build", got, want,
                        {"entries": m, "R": 1, "cap": cap,
                         "valid": int((other >= 0).sum()),
                         "dropped": float(got[1][0])})
    ms = cuda_ms(lambda: sa.route_build(other, mine, **kw), reps=5)
    dev_ms = device_ms(lambda: sa.route_build(other, mine, **kw), 5)
    plain_ms = cuda_ms(lambda: sa.route_build_plain(other, mine, **kw),
                       reps=1)
    nbytes = 2 * m * 4 + cap * 2 * 4 + 4      # pairs in, buffer and count out
    return ms, plain_ms, bound(nbytes, m * ROUTE_OPS), diff, dev_ms


# ------------------------------------------------ the public kernel API
def kernel_api_inputs(cfg):
    """Inputs at the widths the repo uses, made on the card from seeds: K8
    over CONFIG's neurons (homogeneous, and baseline_growth's RS/CH/FS
    table) with one rate window of background input; K6 over the Morton
    codes of CONFIG's positions, one edge table's worth of random 30-bit
    keys and adversarial sets; K7 from CONFIG's neurons to its 8^4 leaf
    cells weighted by their vacant elements; K9 at the attention shapes of
    configs/qwen2_7b.py and configs/recurrentgemma_2b.py."""
    import torch
    from repro_torch.connectome import tree as ctree
    from repro_torch.core import engine, morton
    from repro_torch.core.neuron import NeuronParams
    from repro_torch.scenarios import library
    from repro_torch.scenarios.populations import table_for
    n, s = cfg.neurons_per_rank, cfg.max_synapses
    g = torch.Generator(device=DEV).manual_seed(13)
    st = engine.init_state(cfg, 0, 1, device=DEV)
    pos = st.positions
    table = table_for(cfg, library.baseline_growth(), n, device=DEV)
    hetero = NeuronParams(table.izh_a, table.izh_b, table.izh_c, table.izh_d,
                          table.growth_rate, table.target_calcium)
    k8_state = (torch.randn(n, generator=g, device=DEV) * 5 - 60,
                torch.randn(n, generator=g, device=DEV) * 2 - 13,
                torch.rand(n, generator=g, device=DEV) * 0.01,
                torch.rand(n, generator=g, device=DEV) * 2,
                torch.rand(n, generator=g, device=DEV) * 2)
    k8_input = cfg.background_mean + cfg.background_std * torch.randn(
        cfg.rate_period, n, generator=g, device=DEV)
    top = 2 ** 30 - 1
    i32 = torch.int32
    adversarial = {
        "all_equal": torch.full((n,), 123, dtype=i32, device=DEV),
        "pre_sorted": torch.arange(n, dtype=i32, device=DEV),
        "reversed": torch.arange(n, dtype=i32, device=DEV).flip(0),
        "few_distinct": torch.arange(n, dtype=i32, device=DEV) % 3,
        "extremes": torch.where(torch.arange(n, device=DEV) % 2 == 0, top,
                                0).to(i32),
    }
    tree = ctree.build_local_tree(pos, st.neurons.de_elements, 0, cfg, 1)
    cnt, cent = tree.counts[-1], tree.centroids[-1]
    y = torch.where(cnt[:, None] > 0, cent / cnt.clamp_min(1e-30)[:, None],
                    torch.full_like(cent, 0.5))
    attention = []
    for label, hq, hkv, d, sq, window, dt in ATTENTION_SHAPES:
        dtype = getattr(torch, dt)
        q = torch.randn(1, hq, sq, d, generator=g, device=DEV).to(dtype)
        k = torch.randn(1, hkv, sq, d, generator=g, device=DEV).to(dtype)
        v = torch.randn(1, hkv, sq, d, generator=g, device=DEV).to(dtype)
        attention.append((label, (q, k, v), window))
    return {
        "k8_state": k8_state, "k8_input": k8_input,
        "k8_params": {"homogeneous": None, "heterogeneous": hetero},
        "k6": {"morton": morton.morton_encode(pos, 10),
               "edge_table": torch.randint(0, 2 ** 30, (n * s,), generator=g,
                                           device=DEV, dtype=i32),
               **adversarial},
        "k7": (pos, y.contiguous(), cnt.contiguous()),
        "k9": attention,
    }


def neuron_window(step, inp, cfg, params):
    """One rate window (Delta calls) of a neuron-step function from the
    same state and inputs: the final state and the window's spike total."""
    import torch
    v, u, ca, ax, de = inp["k8_state"]
    spikes = torch.zeros((), dtype=torch.int64, device=DEV)
    for t in range(cfg.rate_period):
        v, u, ca, ax, de, sp = step(v, u, ca, ax, de, inp["k8_input"][t], cfg,
                                    params=params)
        spikes = spikes + sp.sum()
    return v, u, ca, ax, de, sp, spikes


def drive_kernel_api(cfg, inp):
    """The public kernel API on the card: every call goes through
    ``repro_torch.kernels.ops``. Returns the outputs by case."""
    from repro_torch.kernels import ops
    out = {}
    for name, params in inp["k8_params"].items():
        out["K8", name] = neuron_window(ops.fused_neuron_step, inp, cfg,
                                        params)
    for name, keys in inp["k6"].items():
        out["K6", name] = ops.radix_argsort(keys, key_bits=30)
    out["K7"] = ops.gauss_probs(*inp["k7"], sigma=cfg.sigma)
    for label, qkv, window in inp["k9"]:
        out["K9", label] = ops.flash_attention(*qkv, causal=True,
                                               window=window)
    return out


def _same(a, b) -> bool:
    import torch
    return all(torch.equal(x, y) for x, y in zip(a, b))


def attention_pairs(s: int, skv: int, window: int) -> int:
    """Unmasked (q, k) pairs of causal attention with top-left positions."""
    total = 0
    for q in range(s):
        hi = min(q, skv - 1)
        lo = max(q - window + 1, 0) if window > 0 else 0
        total += max(hi - lo + 1, 0)
    return total


def check_kernel_api(cfg, inp, out, counts, k9_kernels, card):
    """Each call of the driven API against its plain version on the same
    inputs, a second call bitwise equal (its kernels' launches counted in
    the C sources: K6's device launches a call, K9's kernel), the launch
    counts (and, for K9, ``k9_kernels``: which kernels the sources counted
    on the driven path), and times. Returns the kernel-table entries of
    K6-K9."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import bh_gauss as bg
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import neuron_step as ns
    from repro_torch.kernels import ops
    from repro_torch.kernels import radix_sort as rs
    want = {"neuron_step": 2 * cfg.rate_period,
            "radix_argsort": len(inp["k6"]), "bh_gauss_probs": 1,
            "flash_attention": len(inp["k9"])}
    for name, k in want.items():
        if counts[name] != k:
            fail(f"{name} launched {counts[name]} times on the kernel API "
                 f"path, not {k}")
    chosen = {}
    for _, (q, _, _), _ in inp["k9"]:
        kernel = fa.kernel_for(q.dtype, q.shape[3])
        chosen[kernel] = chosen.get(kernel, 0) + 1
    if {k: v for k, v in k9_kernels.items() if v} != chosen:
        fail(f"K9's source counted {k9_kernels} launches, not {chosen}")
    entries, lines = {}, []

    # ---- K8: one rate window per variant, bit-equal ----------------------
    n = cfg.neurons_per_rank
    for name, params in inp["k8_params"].items():
        got = out["K8", name]
        plain = neuron_window(ns.neuron_step_plain, inp, cfg, params)
        again = neuron_window(ops.fused_neuron_step, inp, cfg, params)
        exact = _same(got, plain)
        x0 = (*inp["k8_state"], inp["k8_input"][0])
        ms = cuda_ms(lambda: ops.fused_neuron_step(*x0, cfg, params=params),
                     reps=100)
        plain_ms = cuda_ms(lambda: ns.neuron_step_plain(*x0, cfg,
                                                        params=params), reps=10)
        dev_ms = device_ms(lambda: ops.fused_neuron_step(*x0, cfg,
                                                         params=params), 100)
        nbytes = (45 if params is None else 69) * n
        b = bound(nbytes, fp_ops=n * NEURON_STEP_OPS)
        lines.append({"kernel": "K8 neuron_step", "variant": name, "n": n,
                      "calls": cfg.rate_period, "equal": exact,
                      "deterministic": _same(got, again),
                      "spikes": int(got[6]), "ms": ms,
                      "device_ms": dev_ms, "plain_ms": plain_ms,
                      "bound_ms": b[0], "bound_by": b[1]})
        if not exact or not _same(got, again):
            fail(f"K8 ({name}): differs from its plain version or between "
                 f"two runs")
        if name == "homogeneous":
            entries["K8"] = dict(ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
                                 bound=b, max_abs_err=0.0, library_ms=None)

    # ---- K6: bit-equal to the plain version and to torch.sort ------------
    k6_most = 1 + 4          # a digit count, then one launch a pass
    for name, keys in inp["k6"].items():
        got = out["K6", name]
        plain = rs.radix_argsort_plain(keys, key_bits=30)
        srt = torch.sort(keys, stable=True)
        exact = _same(got, plain) and torch.equal(got[0], srt.values) and \
            torch.equal(got[1], srt.indices.to(torch.int32))
        rs.device_launches(reset=True)
        det = _same(got, ops.radix_argsort(keys, key_bits=30))
        k6_launches = rs.device_launches(reset=True)
        if k6_launches > k6_most:
            fail(f"K6 ({name}): {k6_launches} device launches in one call, "
                 f"not at most {k6_most}")
        line = {"kernel": "K6 radix_argsort", "keys": name,
                "n": keys.shape[0], "key_bits": 30, "equal": exact,
                "deterministic": det, "device_kernel": "onesweep",
                "device_launches_per_call": k6_launches}
        if name in ("morton", "edge_table"):
            nk = keys.shape[0]
            line["ms"] = cuda_ms(lambda: ops.radix_argsort(keys, key_bits=30),
                                 reps=10)
            line["device_ms"] = device_ms(
                lambda: ops.radix_argsort(keys, key_bits=30), 10)
            line["plain_ms"] = cuda_ms(
                lambda: rs.radix_argsort_plain(keys, key_bits=30), reps=1)
            line["library_ms"] = cuda_ms(
                lambda: torch.sort(keys, stable=True), reps=10)
            line["library_device_ms"] = device_ms(
                lambda: torch.sort(keys, stable=True), 10)
            b = bound(12 * nk, 4 * nk * SORT_OPS)
            line["bound_ms"], line["bound_by"] = b
            if name == "edge_table":
                entries["K6"] = dict(
                    ms=line["ms"], device_ms=line["device_ms"],
                    plain_ms=line["plain_ms"], bound=b, max_abs_err=0.0,
                    library_ms=line["library_ms"],
                    extra={"device_kernel": "onesweep",
                           "device_launches_per_call": k6_launches})
        lines.append(line)
        if not exact or not det:
            fail(f"K6 ({name}): differs from its plain version, torch.sort "
                 f"or between two runs")

    # ---- K7: P bit-equal, row sums within 1e-6 relative ------------------
    x, y, w = inp["k7"]
    p, rsum = out["K7"]
    pp, prs = bg.bh_gauss_plain(x, y, w, sigma=cfg.sigma)
    p_equal = torch.equal(p, pp)
    rel = float(((rsum - prs).abs() / prs.abs().clamp_min(1e-30)).max())
    det = _same((p, rsum), ops.gauss_probs(x, y, w, sigma=cfg.sigma))
    del pp
    nq, mc = x.shape[0], y.shape[0]
    ms = cuda_ms(lambda: ops.gauss_probs(x, y, w, sigma=cfg.sigma), reps=5)
    dev_ms = device_ms(lambda: ops.gauss_probs(x, y, w, sigma=cfg.sigma), 5)
    plain_ms = cuda_ms(lambda: bg.bh_gauss_plain(x, y, w, sigma=cfg.sigma),
                       reps=1)
    b = bound(12 * nq + 16 * mc + 4 * nq * mc + 4 * nq,
              fp_ops=nq * mc * GAUSS_OPS)
    lines.append({"kernel": "K7 bh_gauss_probs", "N": nq, "M": mc,
                  "sigma": cfg.sigma, "P_equal": p_equal,
                  "rowsum_max_rel_err": rel, "deterministic": det, "ms": ms,
                  "device_ms": dev_ms,
                  "plain_ms": plain_ms, "bound_ms": b[0], "bound_by": b[1],
                  "P_gib": p.numel() * 4 / 2 ** 30})
    if not p_equal or rel > 1e-6 or not det:
        fail(f"K7: P equal {p_equal}, row sums {rel} relative, "
             f"deterministic {det}")
    entries["K7"] = dict(ms=ms, device_ms=dev_ms, plain_ms=plain_ms, bound=b,
                         max_abs_err=float((rsum - prs).abs().max()),
                         library_ms=None)
    del p, rsum, out["K7"]

    # ---- K9: f32 within 2e-5 of the plain version; bf16 within the bound
    # of its roundings (fa.bf16_error_bound), per element ------------------
    worst = 0.0
    for label, (q, k, v), window in inp["k9"]:
        got = out["K9", label]
        plain = fa.flash_attention_plain(q, k, v, causal=True, window=window)
        diff = (got.float() - plain.float()).abs()
        if q.dtype == torch.bfloat16:
            tol = "bf16_error_bound"
            lim = fa.bf16_error_bound(plain, q, k, v, causal=True,
                                      window=window)
        else:
            tol = 2e-5
            lim = tol + tol * plain.float().abs()
        err = float(diff.max())
        ratio = float((diff / lim).max())
        ok = ratio <= 1.0
        fa.device_launches(reset=True)
        det = torch.equal(got, ops.flash_attention(q, k, v, causal=True,
                                                   window=window))
        ran = {nm: n for nm, n in fa.device_launches(reset=True).items()
               if n}
        kernel = fa.kernel_for(q.dtype, q.shape[3])
        if ran != {kernel: 1}:
            fail(f"K9 ({label}): one call launched {ran}, not {kernel} once")
        del plain, diff, lim
        worst = max(worst, err)
        ms = cuda_ms(lambda: ops.flash_attention(q, k, v, causal=True,
                                                 window=window), reps=5)
        dev_ms = device_ms(lambda: ops.flash_attention(
            q, k, v, causal=True, window=window), 5)
        plain_ms = cuda_ms(lambda: fa.flash_attention_plain(
            q, k, v, causal=True, window=window), reps=1)
        if window:
            sq = q.shape[2]
            pos = torch.arange(sq, device=DEV)
            mask = (pos[None, :] <= pos[:, None]) & \
                (pos[:, None] - pos[None, :] < window)
            lib = lambda: F.scaled_dot_product_attention(   # noqa: E731
                q, k, v, attn_mask=mask, enable_gqa=True)
        else:
            lib = lambda: F.scaled_dot_product_attention(   # noqa: E731
                q, k, v, is_causal=True, enable_gqa=True)
        library_ms = cuda_ms(lib, reps=5)
        library_dev_ms = device_ms(lib, 5)
        bq, hq, sq, d = q.shape
        pairs = bq * hq * attention_pairs(sq, k.shape[2], window)
        nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
        rate = H100_BF16_OPS_PER_S if q.dtype == torch.bfloat16 \
            else H100_FP32_OPS_PER_S
        b = bound(nbytes, fp_ops=4 * d * pairs, fp_ops_per_s=rate)
        lines.append({"kernel": "K9 flash_attention", "shape": label,
                      "device_kernel": kernel,
                      "device_launches_per_call": sum(ran.values()),
                      "B": bq, "Hq": hq, "Hkv": k.shape[1], "S": sq, "D": d,
                      "window": window, "dtype": str(q.dtype),
                      "tolerance": tol, "max_abs_err": err,
                      "max_err_over_tolerance": ratio, "within": ok,
                      "deterministic": det, "ms": ms,
                      "device_ms": dev_ms, "plain_ms": plain_ms,
                      "library_ms": library_ms,
                      "library_device_ms": library_dev_ms, "bound_ms": b[0],
                      "bound_by": b[1]})
        if not ok or not det:
            fail(f"K9 ({label}): max |kernel - plain| {err}, at most "
                 f"{ratio} times the tolerance ({tol}), deterministic {det}")
        if label == ATTENTION_SHAPES[0][0]:
            entries["K9"] = dict(ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
                                 bound=b, library_ms=library_ms,
                                 extra={"device_kernel": kernel,
                                        "device_launches_per_call":
                                        sum(ran.values())})
    entries["K9"]["max_abs_err"] = worst
    emit({"phase": "kernel_api", "card": card, "launches": counts,
          "flash_attention_kernels": k9_kernels, "checks": lines})
    return entries


def run_main_path(cfg, chunks: int, scenario=None):
    """A fresh simulator: one warm-up chunk, then ``chunks`` timed chunks,
    each ``run(1)`` (with the recorder when there is a scenario). Returns
    (sim, recorder, warm-up ms, per-chunk ms, per-chunk health flags)."""
    import torch
    from repro_torch.scenarios import observables
    from repro_torch.sim.api import Simulator
    sim = Simulator.from_config(cfg, scenario=scenario, device=DEV)
    rec = None if scenario is None else observables.init_recorder(
        chunks + 1, len(scenario.regions) + 1, device=DEV)
    sim.init()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    per_chunk, flags = [], []
    for _ in range(chunks + 1):
        t0 = time.perf_counter()
        out = sim.run(1, recorder=rec)
        torch.cuda.synchronize()
        per_chunk.append((time.perf_counter() - t0) * 1e3)
        flags.append(sim.health()["health_flags"])
        if rec is not None:
            rec = out[1]
    return sim, rec, per_chunk[0], per_chunk[1:], flags


def scenario_lesions(cfg, scenario):
    """The scenario path's lesion operands at the CONFIG positions."""
    from repro_torch.core import engine
    from repro_torch.scenarios import protocol
    pos = engine.init_state(cfg, 0, 1, scenario, device=DEV).positions
    return protocol.lesion_tables(scenario.events, scenario.regions, pos)


def scaled(scenario, div: int):
    """The scenario with its event times divided by ``div``."""
    from repro_torch.scenarios.protocol import Stimulate
    return dataclasses.replace(scenario, events=tuple(
        dataclasses.replace(e, t0=e.t0 // div, t1=e.t1 // div)
        if isinstance(e, Stimulate) else dataclasses.replace(e, t=e.t // div)
        for e in scenario.events))


def fused_vs_reference(base_cfg, scenario, chunks: int, exact_kernels: bool):
    """Reference and fused lowerings from one seed on a small config: the
    counters, edge tables and (with a scenario, all five lowerings fused)
    the recorder's rows must be equal."""
    import torch
    from repro_torch.scenarios import observables
    from repro_torch.sim.api import Simulator
    fields = ("activity_impl", "connectivity_impl") if scenario is None \
        else ("activity_impl", "connectivity_impl", "tree_impl",
              "apply_impl")
    out = {}
    for impl in ("reference", "fused"):
        cfg = dataclasses.replace(base_cfg, **{f: impl for f in fields})
        sim = Simulator.from_config(cfg, scenario=scenario, device=DEV)
        rows = {}
        if scenario is None:
            sim.run(chunks)
        else:
            rec = observables.init_recorder(chunks, len(scenario.regions) + 1,
                                            device=DEV)
            rows = observables.flush(sim.run(chunks, recorder=rec)[1])
        stats = {k: v for k, v in sim.stats().items()
                 if not k.startswith("launches/")}
        out[impl] = (stats, sim.state.in_edges.cpu(),
                     sim.state.out_edges.cpu(), rows)
    a, b = out["reference"], out["fused"]
    same = a[0] == b[0] and torch.equal(a[1], b[1]) and \
        torch.equal(a[2], b[2]) and \
        all((a[3][k] == b[3][k]).all() for k in observables.FIELDS
            if k in a[3])
    emit({"phase": "fused_vs_reference",
          "config": "SMOKE_CONFIG" if scenario is None
          else "SMOKE_SCENARIO_CONFIG",
          "scenario": None if scenario is None else scenario.name,
          "events": None if scenario is None else repr(scenario.events),
          "lowerings_fused": list(fields), "chunks": chunks, "equal": same,
          "synapses_formed": b[0]["synapses_formed"],
          "synapses_deleted": b[0]["synapses_deleted"]})
    if not same and exact_kernels:
        fail(f"fused and reference lowerings disagree ({scenario})")


def check_path(label, sim, cfg, warm, per_chunk, flags, counts,
               scenario=None, rec=None, device_counts=None):
    """Health, finiteness and shapes of a main-path run, and for the
    scenario path the recorder's rows of the lesioned region. Returns the
    counter names compared by the determinism check."""
    import torch
    from repro_torch.scenarios import observables
    stats = sim.stats()
    st = sim.state
    n = cfg.neurons_per_rank
    finite = all(bool(torch.isfinite(x).all()) for x in (
        st.neurons.v, st.neurons.u, st.neurons.calcium, st.neurons.rate,
        st.positions))
    shapes_ok = (tuple(st.in_edges.shape) == (n, cfg.max_synapses)
                 and tuple(st.neurons.v.shape) == (n,))
    keys = sorted(k for k in stats if not k.startswith("launches/"))
    shown = ("synapses_formed", "synapses_deleted", "activity_spikes",
             "bh_restarts", "bh_requests", "activity_steps",
             "request_overflow")
    line = {"phase": label, "config": "CONFIG, " + ", ".join(
        f"{f}={getattr(cfg, f)!r}" for f in (
            "activity_impl", "connectivity_impl", "tree_impl",
            "apply_impl")),
        "scenario": None if scenario is None else scenario.name,
        "neurons": n, "S": cfg.max_synapses, "chunks": len(per_chunk) + 1,
        "warmup_chunk_ms": warm, "chunk_ms": per_chunk,
        "median_chunk_ms": sorted(per_chunk)[len(per_chunk) // 2],
        "launches": counts, "device_launches": device_counts,
        "health_flags_per_chunk": flags,
        "counters": {k: stats[k] for k in shown}, "finite": finite,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    hist = None
    if rec is not None:
        hist = observables.flush(rec)
        line["recorder"] = {k: hist[k][:, 0].tolist()
                            for k in ("alive", "synapses")}
    emit(line)
    if any(f != 0 for f in flags) or not finite or not shapes_ok:
        fail(f"{label} unhealthy: flags {flags}, finite={finite}")
    if stats["synapses_formed"] <= 0 or stats["activity_spikes"] <= 0:
        fail(f"{label} formed no synapses or fired no spikes")
    if hist is not None:
        # region 0 ('core') dies at the update closing the chunk whose
        # window ends at the lesion step
        first_dead = scenario.events[0].t // cfg.rate_period - 1
        core_alive, core_syn = hist["alive"][:, 0], hist["synapses"][:, 0]
        if (core_alive[first_dead:] != 0).any() or \
                (core_syn[first_dead:] != 0).any():
            fail(f"{label}: the lesioned region kept neurons or synapses")
        if (core_alive[:first_dead] == 0).any():
            fail(f"{label}: the region died before its lesion")
    return keys


def scenario_determinism(sim, rec, cfg, scenario, chunks, keys, card):
    """A second scenario run from the same seed, as one
    ``run(chunks, recorder=rec)`` call: edge tables, counters and recorder
    bitwise equal to the first. Then one more chunk, profiled."""
    import torch
    from repro_torch.scenarios import observables
    from repro_torch.sim.api import Simulator
    sim2 = Simulator.from_config(cfg, scenario=scenario, device=DEV)
    rec2 = observables.init_recorder(chunks, len(scenario.regions) + 1,
                                     device=DEV)
    _, rec2 = sim2.run(chunks, recorder=rec2)
    h1, h2 = observables.flush(rec), observables.flush(rec2)
    s1, s2 = sim.stats(), sim2.stats()
    same = (torch.equal(sim.state.in_edges, sim2.state.in_edges)
            and torch.equal(sim.state.out_edges, sim2.state.out_edges)
            and all(s1[k] == s2[k] for k in keys)
            and all((h1[k] == h2[k]).all() for k in observables.FIELDS))
    emit({"phase": "determinism", "path": "scenario_path", "equal": same})
    if not same:
        fail("a second run of the scenario path from the same seed differs")
    phase_profile(sim2, card)


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
    emit({"phase": "profile", "card": card,
          "scenario": getattr(sim.scenario, "name", None),
          "chunk": sim.state.chunk - 1, "chunk_wall_ms": wall_ms,
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
    all_fused = dataclasses.replace(slice_cfg, tree_impl="fused",
                                    apply_impl="fused")
    from repro_torch.scenarios import library
    scn = library.lesion_rewiring()

    # ---- kernels against their plain versions --------------------------
    check_k0()
    k1 = k1_compare(slice_cfg)
    k1s = k1_compare(all_fused, num_ranks=1, rank=0,
                     tables=k1_scenario_tables(all_fused, chunk=2))
    k1_ms, k1_dev, k1_plain, (k1_bound, k1_by), k1_launches = k1_timing(
        all_fused, 1, 0, lesions=scenario_lesions(all_fused, scn))
    k1r4 = k1_timing(all_fused, 4, 1)
    for per_window in (k1_launches, k1r4[4]):
        if sum(per_window.values()) != 1 or per_window["staged"] != 1:
            fail(f"K1: {per_window} device launches in one window, not one "
                 f"staged launch")
    k2_ms, k2_dev, k2_plain, (k2_bound, k2_by), k2_err, k2_abs = \
        k2_compare_and_time(slice_cfg)
    k3 = check_k3(all_fused)
    k4 = check_k4(all_fused)
    k5 = check_k5(all_fused)
    # device_ms: the calls queued behind a device-side sleep, the host's
    # work hidden (K1: one 100-step window, one launch)
    emit({"phase": "kernel_times", "card": card, "K1_ms": k1_ms,
          "K1_device_ms": k1_dev, "K1_plain_ms": k1_plain,
          "K1_bound_ms": k1_bound,
          "K1_device_launches_per_window": k1_launches,
          "K1_R4_ms": k1r4[0], "K1_R4_device_ms": k1r4[1],
          "K1_R4_plain_ms": k1r4[2], "K1_R4_bound_ms": k1r4[3][0],
          "K1_R4_bound_by": k1r4[3][1],
          "K1_R4_device_launches_per_window": k1r4[4], "K2_ms": k2_ms,
          "K2_device_ms": k2_dev, "K2_plain_ms": k2_plain,
          "K3_ms": k3[0], "K3_device_ms": k3[4], "K3_plain_ms": k3[1],
          "K4_drain_ms": k4["drain"][0],
          "K4_drain_device_ms": k4["drain"][4],
          "K4_drain_plain_ms": k4["drain"][1],
          "K4_drain_bound_ms": k4["drain"][2][0],
          "K4_device_launches_per_call": k4["drain"][5],
          "K4_accept_ms": k4["accept"][0],
          "K4_accept_device_ms": k4["accept"][4],
          "K4_accept_plain_ms": k4["accept"][1],
          "K4_accept_bound_ms": k4["accept"][2][0],
          "K5_ms": k5[0], "K5_device_ms": k5[4], "K5_plain_ms": k5[1]})

    # ---- the public kernel API: K6-K9 at the repo's widths ---------------
    from repro_torch.kernels import flash_attention as fa
    api_inp = kernel_api_inputs(all_fused)
    _build.reset_launch_counts()
    fa.device_launches(reset=True)
    api_out = drive_kernel_api(all_fused, api_inp)
    torch.cuda.synchronize()
    api_counts = _build.launch_counts()
    k9_kernels = fa.device_launches(reset=True)
    api = check_kernel_api(all_fused, api_inp, api_out, api_counts,
                           k9_kernels, card)
    del api_inp, api_out
    torch.cuda.empty_cache()     # the paths start from an empty cache

    # ---- fused == reference on the card, small size --------------------
    exact_kernels = k1["exact"] and k1s["exact"] and k2_err == 0
    fused_vs_reference(SMOKE_CONFIG, None, 3, exact_kernels)
    for name in ("lesion_rewiring", "focal_stimulation"):
        fused_vs_reference(library.SMOKE_SCENARIO_CONFIG,
                           scaled(library.get_scenario(name), 5), 4,
                           exact_kernels)

    # ---- path 1: activity + traversal kernels, no scenario --------------
    _build.reset_launch_counts()
    sim, _, warm, per_chunk, flags = run_main_path(slice_cfg, 2)
    counts = _build.launch_counts()
    chunks = len(per_chunk) + 1
    keys = check_path("main_path", sim, slice_cfg, warm, per_chunk, flags,
                      counts)
    if counts["activity_window"] != chunks:
        fail(f"K1 launched {counts['activity_window']} times, not once a "
             f"window")
    if counts["bh_traverse"] < chunks:
        fail(f"K2 launched {counts['bh_traverse']} times")
    sim2, _, _, _, _ = run_main_path(slice_cfg, 2)
    same = (torch.equal(sim.state.in_edges, sim2.state.in_edges)
            and torch.equal(sim.state.out_edges, sim2.state.out_edges)
            and all(sim2.stats()[k] == sim.stats()[k] for k in keys))
    emit({"phase": "determinism", "path": "main_path", "equal": same})
    if not same:
        fail("a second run of the main path from the same seed differs")
    del sim, sim2

    # ---- path 2: the scenario through the lesion, all five kernels ------
    chunks = 12
    from repro_torch.kernels import activity_fused as af
    from repro_torch.kernels import synapse_apply as sa
    _build.reset_launch_counts()
    af.device_launches(reset=True)
    sa.device_launches(reset=True)
    sim, rec, warm, per_chunk, flags = run_main_path(all_fused, chunks - 1,
                                                     scn)
    counts = _build.launch_counts()
    device_counts = {"activity_window": af.device_launches(reset=True),
                     "synapse_apply": sa.device_launches(reset=True)}
    keys = check_path("scenario_path", sim, all_fused, warm, per_chunk,
                      flags, counts, scenario=scn, rec=rec,
                      device_counts=device_counts)
    want = {"activity_window": chunks, "morton_sort": chunks,
            "synapse_apply": 3 * chunks, "route_build": 2 * chunks}
    for name, k in want.items():
        if counts[name] != k:
            fail(f"{name} launched {counts[name]} times on the scenario "
                 f"path, not {k}")
    if device_counts["activity_window"] != {"staged": chunks,
                                            "streaming": 0} or \
            device_counts["synapse_apply"] != 3 * chunks:
        fail(f"the sources counted {device_counts} device launches on the "
             f"scenario path, not {chunks} staged K1 and {3 * chunks} K4")
    if counts["bh_traverse"] < chunks:
        fail(f"K2 launched {counts['bh_traverse']} times")
    scenario_determinism(sim, rec, all_fused, scn, chunks, keys, card)

    kernels = [
        {"name": "activity_window", "route": "cuda",
         "source": "src/repro_torch/csrc/activity_window.cu",
         "replaces": "src/repro/kernels/activity_fused.py:279",
         "launches": counts["activity_window"],
         "max_abs_err": max(k1["max_abs_err"], k1s["max_abs_err"]),
         "ms": k1_ms, "device_ms": k1_dev, "plain_ms": k1_plain,
         "bound_ms": k1_bound, "bound_by": k1_by, "library_ms": None,
         "device_launches_per_window": sum(k1_launches.values()),
         "R4": {"ms": k1r4[0], "device_ms": k1r4[1], "plain_ms": k1r4[2],
                "bound_ms": k1r4[3][0], "bound_by": k1r4[3][1]}},
        {"name": "bh_traverse", "route": "cuda",
         "source": "src/repro_torch/csrc/bh_traverse.cu",
         "replaces": "src/repro/kernels/bh_traverse.py:77",
         "launches": counts["bh_traverse"], "max_abs_err": k2_abs,
         "ms": k2_ms, "device_ms": k2_dev, "plain_ms": k2_plain,
         "bound_ms": k2_bound, "bound_by": k2_by, "library_ms": None},
        {"name": "morton_sort", "route": "cuda",
         "source": "src/repro_torch/csrc/morton_sort.cu",
         "replaces": "src/repro/kernels/radix_sort.py:135",
         "launches": counts["morton_sort"], "max_abs_err": k3[3],
         "ms": k3[0], "device_ms": k3[4], "plain_ms": k3[1],
         "bound_ms": k3[2][0],
         "bound_by": k3[2][1], "library_ms": None},
        {"name": "synapse_apply", "route": "cuda",
         "source": "src/repro_torch/csrc/synapse_apply.cu",
         "replaces": "src/repro/kernels/synapse_apply.py:63",
         "launches": counts["synapse_apply"],
         "max_abs_err": max(k4["drain"][3], k4["accept"][3]),
         "ms": k4["drain"][0], "device_ms": k4["drain"][4],
         "plain_ms": k4["drain"][1],
         "bound_ms": k4["drain"][2][0], "bound_by": k4["drain"][2][1],
         "library_ms": None, "device_launches_per_call": k4["drain"][5],
         "accept": {"ms": k4["accept"][0], "device_ms": k4["accept"][4],
                    "plain_ms": k4["accept"][1],
                    "bound_ms": k4["accept"][2][0]}},
        {"name": "route_build", "route": "cuda",
         "source": "src/repro_torch/csrc/synapse_apply.cu",
         "replaces": "src/repro/kernels/synapse_apply.py:95",
         "launches": counts["route_build"], "max_abs_err": k5[3],
         "ms": k5[0], "device_ms": k5[4], "plain_ms": k5[1],
         "bound_ms": k5[2][0],
         "bound_by": k5[2][1], "library_ms": None},
    ]
    for name, key, source, replaces in (
            ("radix_argsort", "K6", "radix_argsort.cu", "radix_sort.py:99"),
            ("bh_gauss_probs", "K7", "bh_gauss.cu", "bh_gauss.py:78"),
            ("neuron_step", "K8", "neuron_step.cu", "neuron_step.py:90"),
            ("flash_attention", "K9", "flash_attention.cu",
             "flash_attention.py:94")):
        e = api[key]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/csrc/" + source,
            "replaces": "src/repro/kernels/" + replaces,
            "launches": api_counts[name], "max_abs_err": e["max_abs_err"],
            "ms": e["ms"], "device_ms": e["device_ms"],
            "plain_ms": e["plain_ms"],
            "bound_ms": e["bound"][0], "bound_by": e["bound"][1],
            "library_ms": e["library_ms"], **e.get("extra", {})})
    emit({"phase": "done", "seconds": time.perf_counter() - t_start,
          "card": card})
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
