#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port starts and is right on one GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/csrc`` (nvcc, sm_90a),
holds each kernel (K0-K5, and the retraction and synapse-priority kernels of
``csrc/retract.cu``) against its plain torch version on the card at the main
paths' shapes, drives the public kernel API (``repro_torch.kernels.ops``:
K6 radix argsort, K7 Gaussian probabilities, K8 neuron step, K9 flash
attention) at the widths the repo uses and holds each call against its plain
version, and drives two paths at the full width of ``CONFIG`` (65,536
neurons, S=32):

- the activity + traversal path, ``Simulator.from_config(cfg).run(k)`` with
  ``activity_impl`` and ``connectivity_impl`` fused (K1, K2);
- the scenario path, ``Simulator.from_config(cfg, scenario=lesion_rewiring(),
  device="cuda").run(12, recorder=rec)`` with all five lowerings fused (K1-K5,
  retraction and the acceptance priorities; K0's kernel draws
  ``init_state``'s positions and vacancies), through the lesion at step
  1,000;
- the multi-rank path, the scenario path at ``num_ranks=4``: four ranks of
  65,536 neurons in this process on the one card (``dist.LocalComm``, one
  rank at a time, the collectives as tensor ops), phase A over the
  replicated top tree, formation requests, responses and deletion
  notifications across ranks, K1 reading live remote rates; with its
  kernel checks at rank 3 of 4's shapes (K2 over 131,072 query slots with
  gid_base 3n, K3 at two branch cells, K4 with 131,072 messages or
  requests, K5 into four buckets) and fused == reference at R=4;
- the paper's comparisons (``comparison_paths``): the multi-rank cell with
  ``requests_cap_factor`` 4 and the lesion at step 250, run four ways in
  turns, (a) new / dense, (b) ``connectivity_alg="old"`` (the global tree
  downloaded, K2 searching it), (c) ``rate_exchange="sparse"`` (K1 reading
  the subscribed rates through the slot remap), (d) ``spike_alg="old"``
  (the per-step spiked-ID exchange on the reference activity lowering),
  then (b)-(d) again: (b) and (c) bitwise equal to (a), the second runs to
  the first, and the ratios of the paper's abstract as this one card shows
  them; with its kernel checks (K0's GUMBEL and NORMAL draws, K1's sparse
  operand, K2 on the global tree, K4's accept of R x n requests);
- the workloads (``workloads_path``): ``run_engram`` from a loaded
  hemibrain-shaped surrogate connectome at R=1 (12 chunks, then again chunk
  by chunk, bitwise equal, and under the all-reference lowering with the
  same health flags chunk by chunk), ``run_assimilation`` through
  ``step_with`` (12 chunks, one DynamicParams signature,
  ``step_with(zeros)`` == ``step()``), and ``from_connectome`` at R=4
  (262,144 neurons) under the dense and the sparse exchange in lockstep,
  sparse == dense bitwise, health flags 0; with the tree assembly
  (``csrc/leaf_sums.cu``: the leaf sums, the parent levels and the
  membership table in one cooperative launch) and K3 held against their
  plain versions at R=1, at rank 3 of the multi-rank path and at ranks 1-3
  of the R=4 surrogate, whose rows are clamped into one leaf;
- the runtime (``runner_path``): ``SimulationRunner(SimRunnerConfig(dir,
  ckpt_every=2), cfg=CONFIG, scenario=lesion_rewiring()).run(6)`` with all
  five lowerings fused, every kernel of the path launched under it;
  preempted at chunk 4 and resumed by a fresh runner, and a NaN rolled
  back, each bitwise the uninterrupted run; a truncated newest checkpoint
  skipped; the comparison cell saved at R=4 and restored at R=2
  (``elastic.remesh_restore_brain``), old == new and sparse == dense
  bitwise; checkpoint MB and the save, restore and probe times;
- the multi-tenant service (``service_path``): ``SimulationService(cfg,
  ServiceConfig(num_slots=4, queue_cap=8), scenario=lesion_rewiring())``
  with six tenants submitted as ``launch/serve.py`` submits them, every
  lane on the five fused lowerings, slot 1 NaN-poisoned after its first
  chunk and rolled back: every tenant bitwise its solo run, co-tenant
  observations bitwise an unpoisoned run's, the launches those of the
  admissions and lane-chunks; R=4 dense and sparse on two slots; tick ms,
  requests a second, ``isolation_overhead_x``, a profiled tick's idle
  share and the readouts' ms (``service_metrics``);
- the LM serving path (``lm_serve_path``, each cell in a process of its
  own): ``build_model(get_config(arch))`` for qwen2-7b (28 layers, B=8, a
  1,024-token prompt, 32 greedy decode steps) and recurrentgemma-2b (26
  layers, 8 of them local attention; B=4, a 2,560-token prompt past the
  2,048 window, 32 steps), bf16 at full width and depth, the prefill's
  attention on K9: K9's launches one a prefill attention layer and none a
  decode step, fused == the reference attention lowering (logits within
  twice the reference's own error against its f32 evaluation, greedy
  tokens equal but for counted near-ties), prefill + decode == forward,
  a second run bitwise equal, a decode step with no host wait; prefill ms,
  decode ms a step, tokens a second and peak GB beside their bounds, a
  profiled decode step.

For the kernel API and each path it checks the kernels really ran there (the
launch counts are set to 0 just before and read just after; for K9, which of
its three kernels each shape took; for K1, K3, K4 and K5 on the scenario
and multi-rank paths, the device launches counted in the .cu sources) and
that a second run is bitwise equal (on the multi-rank path also symmetric
edge tables over all ranks, edges across ranks and K5's messages to other
ranks after the lesion), then profiles one chunk of each path (every
thread; on the multi-rank path the ranges' device work assigned by
launching thread), and prints one JSON line per phase. Every kernel is timed twice: a call (CUDA events around back-to-back
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
# one Threefry-2x32 (csrc/hash.cuh) as nvcc compiles it for sm_90a with the
# library's flags, the key schedule shared (tools/k0_sass.py): 20 rotates
# (SHF.L.W), 20 xors (LOP3) and 27 adds (IADD3 adds three operands, so a key
# injection or the initial add joins a round's add); the source's count
# was 2 + 20 x 3 + 5 x 2 = 72
HASH_OPS = 67
# a draw's epilogue beyond its hash(es), integer and float operations:
# uniform xor, shift, or / subtract, multiply-add, max; randint two xors,
# three modulos, a multiply, two adds
UNIFORM_EPILOGUE = (3, 3)
RANDINT_EPILOGUE = (8, 0)
NEURON_OPS = 60       # Box-Muller tail + Izhikevich + calcium + elements
# a slot of K1's row a step (rank split and rate are decoded once a window):
# code load, local test, word index, word load, bit shift, bit test
SLOT_OPS = 6
# K2's node statistics from a packed node (count, centre): |y|^2, <x,y>
# and d2 (13), two clamps, sqrt, two divisions, exp, the weight's product
# and two compares; earlier slices counted 40 (with the centre's three
# divisions, now made once a node a call)
NODE_OPS = 24
NODE_OPS_EARLIER = 40
RANK_OPS = 3          # a slot pair of retract's rank: shuffle, two compares
GUMBEL_LOG_OPS = 20   # the two logs of a Gumbel draw (float)
# a counter-hash draw's epilogue beyond its hash, integer and float
# operations: the 24-bit unit (shift; convert, multiply), the Gumbel's clamp
# and two logs with their negations, Box-Muller's two units, log1p, sqrt and
# cos with their products
UNIT_EPILOGUE = (1, 2)
GUMBEL_EPILOGUE = (1, 5 + GUMBEL_LOG_OPS)
NORMAL_EPILOGUE = (2, 34)
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


def k0_cases(cfg):
    """K0's draws at the main paths' shapes: ``init_state``'s three (randint
    (n,) of the cells, uniform (n, 3) offsets, uniform (n, 2) vacancies;
    keys as host words) and the reference lowering's priorities of one
    table (``edge_priority``: fold_in of the row gids, fold_in of the
    partners, uniform of the batch; n x S keys). Each: (kernel call, plain
    call, bytes, integer and float operations)."""
    import torch
    from repro_torch import prng
    from repro_torch.core import morton
    n, s = cfg.neurons_per_rank, cfg.max_synapses
    m = n * s
    cells = morton.cells_per_rank(1)
    kp, kn = prng.split_words(prng.fold_in_words(prng.key_words(cfg.seed), 0))
    kc, ko = prng.split_words(kp)
    kv, _ = prng.split_words(kn)
    t = {w: prng.key_tensor(w, DEV) for w in (kc, ko, kv)}
    g = torch.Generator(device=DEV).manual_seed(14)
    a = torch.arange(n, dtype=torch.int32, device=DEV).repeat_interleave(s)
    b = torch.randint(0, n, (m,), generator=g, device=DEV, dtype=torch.int32)
    k_out = prng.split_words(prng.fold_in_words(prng.key_words(cfg.seed + 2),
                                                3), 3)[0]
    t_out = prng.key_tensor(k_out, DEV)
    rows = prng.fold_in(k_out, a)
    pairs = prng.fold_in(rows, b)
    lo, hi = cfg.initial_vacant_low, cfg.initial_vacant_high
    ui, uf = UNIFORM_EPILOGUE
    return {
        "randint (n,)": (
            lambda: prng.randint(kc, (n,), 0, cells, device=DEV),
            lambda: prng.randint_plain(t[kc], (n,), 0, cells),
            4 * n, n * (2 * HASH_OPS + RANDINT_EPILOGUE[0]) + 2 * HASH_OPS,
            0),
        "uniform (n, 3)": (
            lambda: prng.uniform(ko, (n, 3), device=DEV),
            lambda: prng.uniform_plain(t[ko], (n, 3)),
            12 * n, 3 * n * (HASH_OPS + ui), 3 * n * uf),
        "uniform (n, 2)": (
            lambda: prng.uniform(kv, (n, 2), lo, hi, device=DEV),
            lambda: prng.uniform_plain(t[kv], (n, 2), lo, hi),
            8 * n, 2 * n * (HASH_OPS + ui), 2 * n * uf),
        "fold_in rows (n S,)": (
            lambda: prng.fold_in(k_out, a),
            lambda: prng.fold_in_plain(t_out, a),
            4 * m + 16 * m, m * HASH_OPS, 0),
        "fold_in pairs (n S,)": (
            lambda: prng.fold_in(rows, b),
            lambda: prng.fold_in_plain(rows, b),
            16 * m + 4 * m + 16 * m, m * HASH_OPS, 0),
        "uniform pairs (n S,)": (
            lambda: prng.uniform(pairs),
            lambda: prng.uniform_plain(pairs),
            16 * m + 4 * m, m * (HASH_OPS + ui), m * uf),
    }


def check_k0(cfg):
    """K0's draw kernel against the plain int64 Threefry: threefry_words on
    1M random words (int64, and int32 and strided views), then every draw
    kind at the main paths' shapes (``k0_cases``), each bit-equal, one
    device launch a call (counted in csrc/hash_words.cu), timed (call,
    device, plain) beside its bound. Returns the kernel-table entry (the
    (n, 3) uniform, init_state's largest draw) and the lines by case."""
    import torch
    from repro_torch.kernels import hash as chash
    g = torch.Generator(device=DEV).manual_seed(0)
    words = [torch.randint(0, 2 ** 32, (1 << 20,), generator=g,
                           device=DEV, dtype=torch.int64)
             for _ in range(4)]
    got = chash.threefry_words(*words)
    want = chash.threefry2x32(*words)
    bad = int((got[0] != want[0]).sum() + (got[1] != want[1]).sum())
    mixed = (words[0][::2].to(torch.int32), 7, words[2][::2],
             words[3][1::2])
    bad += int(sum((x != y).sum() for x, y in zip(
        chash.threefry_words(*mixed), chash.threefry2x32(*mixed))))
    lines, entry = [], None
    for name, (kernel, plain, nbytes, iops, fops) in k0_cases(cfg).items():
        chash.device_launches(reset=True)
        out = kernel()
        torch.cuda.synchronize()
        launched = chash.device_launches(reset=True)
        exact = torch.equal(out, plain())
        ms = cuda_ms(kernel, reps=20)
        dev_ms = device_ms(kernel, 20)
        plain_ms = cuda_ms(plain, reps=3)
        b = bound(nbytes, iops, fops)
        lines.append({"draw": name, "elements": out.numel(), "equal": exact,
                      "device_launches_per_call": launched, "ms": ms,
                      "device_ms": dev_ms, "plain_ms": plain_ms,
                      "bound_ms": b[0], "bound_by": b[1]})
        if not exact or launched != 1:
            fail(f"K0 {name}: equal {exact}, {launched} device launches in "
                 f"one call (not 1)")
        if name == "uniform (n, 3)":
            entry = dict(ms=ms, device_ms=dev_ms, plain_ms=plain_ms, bound=b,
                         max_abs_err=0.0)
    emit({"phase": "check", "kernel": "K0 threefry2x32", "words": 1 << 21,
          "mismatches": bad, "draws": lines})
    if bad:
        fail(f"K0: {bad} threefry words differ from the plain version")
    return entry, lines


def retract_cases(cfg):
    """Retraction inputs at CONFIG's shape (n, S): full random rows with
    random deletion counts, the scenario's sparse rows (about 0.25 synapses
    a neuron, a few to delete), lesion rows (n_delete at or above the count
    on half the rows) and rows holding partners twice (tied priorities, the
    slot order decides)."""
    import torch
    n, s = cfg.neurons_per_rank, cfg.max_synapses
    g = torch.Generator(device=DEV).manual_seed(8)
    i32 = torch.int32

    def ri(lo, hi, *shape):
        return torch.randint(lo, hi, shape, generator=g, device=DEV,
                             dtype=i32)

    gids = torch.arange(n, dtype=i32, device=DEV)
    full = ri(0, n, n, s)
    sparse = torch.where(torch.rand(n, s, generator=g, device=DEV) < 0.25 / s,
                         ri(0, n, n, s), -1)
    lesion = torch.where(torch.rand(n, s, generator=g, device=DEV) < 0.5,
                         ri(0, n, n, s), -1)
    dup = ri(0, 4, n, s) + (gids[:, None] % 1000)
    dup = torch.where(torch.rand(n, s, generator=g, device=DEV) < 0.2, -1,
                      dup)
    cnt = lambda e: (e >= 0).sum(1, dtype=i32)    # noqa: E731
    return {
        "full": (full, ri(0, s + 1, n)),
        "scenario_sparse": (sparse, torch.clamp_min(
            cnt(sparse) - ri(0, 2, n), 0)),
        "lesion": (lesion, torch.where(gids % 2 == 0, cnt(lesion) + ri(0, 3, n),
                                       ri(0, 4, n))),
        "duplicates": (dup, ri(0, s + 1, n)),
    }, gids


def check_retract(cfg):
    """The retraction kernel bit-equal to ``retract_synapses`` and the
    priority entry to ``request_priority`` at CONFIG's shapes (keys as the
    chunk derives them), each timed beside its plain version and bound."""
    import torch
    from repro_torch import prng
    from repro_torch.connectome import routing
    from repro_torch.connectome import synapses as syn
    from repro_torch.kernels import retract as kr
    k_out, _, k_accept = prng.split_words(
        prng.fold_in_words(prng.key_words(cfg.seed + 2), 3), 3)
    t_out = prng.key_tensor(k_out, DEV)
    cases, gids = retract_cases(cfg)
    n, s = cfg.neurons_per_rank, cfg.max_synapses
    res, worst = {}, 0.0
    for name, (edges, nd) in cases.items():
        got = kr.retract(k_out, edges, nd, gids)
        want = syn.retract_synapses(t_out, edges, nd, gids)
        occ = edges >= 0
        counts = occ.sum(1)
        drawing = (nd > 0) & (nd < counts)
        worst = max(worst, _check_exact(
            f"retract ({name})", got, want,
            {"n": n, "S": s, "occupied": int(occ.sum()),
             "killed": int(got[1].sum()),
             "rows_that_draw": int(drawing.sum())}))
        if name in ("full", "scenario_sparse"):
            ms = cuda_ms(lambda: kr.retract(k_out, edges, nd, gids), reps=10)
            dev_ms = device_ms(lambda: kr.retract(k_out, edges, nd, gids),
                               10)
            plain_ms = cuda_ms(lambda: syn.retract_synapses(
                t_out, edges, nd, gids), reps=2)
            slots = int((occ & drawing[:, None]).sum())
            int_ops = (int(drawing.sum()) + 2 * slots) * HASH_OPS \
                + slots * s * RANK_OPS
            res[name] = (ms, dev_ms, plain_ms,
                         bound(n * s * 9 + 8 * n, int_ops))
    # the acceptance priorities of a full request buffer
    q = routing.cap_requests(cfg, 1)
    g = torch.Generator(device=DEV).manual_seed(9)
    tgt = torch.randint(0, n, (q,), generator=g, device=DEV,
                        dtype=torch.int32)
    src = torch.randint(0, n, (q,), generator=g, device=DEV,
                        dtype=torch.int32)
    valid = torch.rand(q, generator=g, device=DEV) < 0.7
    t_acc = prng.key_tensor(k_accept, DEV)
    got = kr.edge_priority(k_accept, src, tgt, valid)
    want = syn.request_priority(t_acc, tgt, src, valid)
    worst_p = _check_exact("edge_priority (request buffer)", (got,), (want,),
                           {"Q": q, "valid": int(valid.sum())})
    p_ms = cuda_ms(lambda: kr.edge_priority(k_accept, src, tgt, valid),
                   reps=10)
    p_dev = device_ms(lambda: kr.edge_priority(k_accept, src, tgt, valid), 10)
    p_plain = cuda_ms(lambda: syn.request_priority(t_acc, tgt, src, valid),
                      reps=2)
    res["priority"] = (p_ms, p_dev, p_plain,
                       bound(q * 13, q * 3 * HASH_OPS))
    return res, max(worst, worst_p)


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
    # the main path packs the tree's real level widths (traverse.phase_b_fused)
    widths = tuple(c.shape[0] for c in tree.counts)
    return args, kw, widths


def k2_inputs_ranks(cfg, num_ranks: int = 4, rank: int = 3):
    """K2 as rank ``rank`` of ``num_ranks`` runs it on the multi-rank path:
    its subtree (two branch cells at R=4), gid_base = rank*n, and the
    R*cap_requests received query slots in rank-major blocks, each block's
    valid requests first: the rank's own block full (its searchers mostly
    pick their own cells in phase A), the other blocks sharing the rest of
    n valid queries (about half the slots valid, as a rank receives at most
    about n); invalid slots as ``routing.formation_new`` passes them
    (source -2, start 0, position 0)."""
    import torch
    from repro_torch.connectome import routing
    from repro_torch.connectome import traverse
    from repro_torch.connectome import tree as ctree
    from repro_torch.core import engine, morton
    n = cfg.neurons_per_rank
    b = morton.branch_level(num_ranks)
    c_per = morton.cells_per_rank(num_ranks)
    st = engine.init_state(cfg, rank, num_ranks, device=DEV)
    vac = st.neurons.de_elements
    tree = ctree.build_local_tree(st.positions, vac, rank, cfg, num_ranks)
    stacked = traverse.stack_levels(tree.counts, tree.centroids, b)
    cap = routing.cap_requests(cfg, num_ranks)
    q = num_ranks * cap
    others = (n - cap) // (num_ranks - 1)
    x = torch.zeros(q, 3, device=DEV)
    src = torch.full((q,), -2, dtype=torch.int32, device=DEV)
    start = torch.zeros(q, dtype=torch.int32, device=DEV)
    for s in range(num_ranks):
        k = cap if s == rank else others
        pos = engine.init_state(cfg, s, num_ranks, device=DEV).positions[:k]
        rows = slice(s * cap, s * cap + k)
        x[rows] = pos
        src[rows] = s * n + torch.arange(k, dtype=torch.int32, device=DEV)
        start[rows] = (morton.morton_encode(pos, b) % c_per).to(torch.int32)
    valid = src >= 0
    kw = dict(seed=cfg.seed, sizes=stacked.sizes, theta=cfg.theta,
              sigma=cfg.sigma, frontier=cfg.frontier_cap,
              n_levels=cfg.local_levels + 1)
    args = (stacked.counts, stacked.centroids, tree.leaf_members,
            st.positions, vac, x, start, src, valid, 2, rank * n)
    widths = tuple(c.shape[0] for c in tree.counts)
    return args, kw, widths


def k2_work(args, kw):
    """The work K2's search needs on these inputs, replayed with the plain
    version's arithmetic (``traverse.expand_and_sample``, ``bh_search``,
    ``select_member``): node evaluations (each frontier entry's statistics
    once, for the sub-rounds up to the fixed point and the settled
    frontier), Gumbel draws of the valid nonempty settled entries and of the
    valid leaf members, and the frontier entries of every sub-round the
    search runs up to its fixed point (the count the per-entry evaluation
    would take). Returns a dict of counts."""
    import torch
    from repro_torch.connectome import traverse as tv
    (counts, cents, members, npos, vac, x, start, gid, _, chunk,
     gid_base) = args
    f, n_levels = kw["frontier"], kw["n_levels"]
    last = n_levels - 1
    tree = tv.StackedTree(counts, cents, tuple(kw["sizes"]), 0)
    q = x.shape[0]
    dev = x.device
    i32 = torch.int32
    js = torch.arange(8, dtype=i32, device=dev)
    cell = start.to(i32)
    rel = torch.zeros(q, dtype=i32, device=dev)
    done = torch.zeros(q, dtype=torch.bool, device=dev)
    evals = draws = entries = rounds = 0
    for i in range(n_levels):
        active = ~done
        rounds += int(active.sum())
        at_leaf = rel >= last
        cells = torch.zeros((q, f), dtype=i32, device=dev)
        lvls = torch.zeros((q, f), dtype=i32, device=dev)
        valid = torch.zeros((q, f), dtype=torch.bool, device=dev)
        cells[:, :8] = torch.where(at_leaf, cell, cell * 8)[:, None] + \
            torch.where(at_leaf[:, None], 0, js[None, :])
        lvls[:, :8] = torch.where(at_leaf, rel, rel + 1)[:, None]
        valid[:, :8] = torch.where(at_leaf[:, None], js[None] == 0, True)
        evals += int((valid & active[:, None]).sum())
        settled = torch.zeros(q, dtype=torch.bool, device=dev)
        for _ in range(n_levels):
            cnt, _, crit = tv._node_stats(tree, lvls, cells, x, kw["sigma"])
            nonempty = cnt > 1e-9
            expand = valid & nonempty & ~((crit < kw["theta"]) |
                                          (lvls >= last))
            keep = valid & ~expand & nonempty
            need = torch.where(expand, 8, torch.where(keep, 1, 0))
            fits = tv._excl_cumsum(need) + need <= f
            need2 = torch.where(expand & fits, 8,
                                torch.where(keep | (expand & ~fits), 1, 0))
            off2 = tv._excl_cumsum(need2)
            need2 = torch.where(off2 + need2 <= f, need2, 0)
            run = active & ~settled
            entries += int((valid & run[:, None]).sum())
            settled = settled | ~torch.any(valid & (need2 != 1), dim=1)
            grow = run & ~settled
            evals += int(((need2 == 8) & grow[:, None]).sum()) * 8
            nc = torch.zeros((q, f + 1), dtype=i32, device=dev)
            nl = torch.zeros((q, f + 1), dtype=i32, device=dev)
            nv = torch.zeros((q, f + 1), dtype=torch.bool, device=dev)
            one = need2 == 1
            t1 = torch.where(one, off2, f)
            nc.scatter_(1, t1, cells)
            nl.scatter_(1, t1, lvls)
            nv.scatter_(1, t1, one)
            t8 = torch.where((need2 == 8)[..., None], off2[..., None] + js,
                             f).reshape(q, -1)
            nc.scatter_(1, t8, (cells[..., None] * 8 + js).reshape(q, -1))
            nl.scatter_(1, t8, (lvls[..., None] + 1).expand(q, f, 8)
                        .reshape(q, -1))
            nv.scatter_(1, t8, (need2 == 8)[..., None].expand(q, f, 8)
                        .reshape(q, -1))
            cells, lvls, valid = nc[:, :f], nl[:, :f], nv[:, :f]
        cnt, _, _ = tv._node_stats(tree, lvls, cells, x, kw["sigma"])
        live = valid & (cnt > 1e-9)
        draws += int((live & active[:, None]).sum())
        ncell, nrel, nvalid, _ = tv.expand_and_sample(
            tree, x, cell, rel, gid, tv.PHASE_B_ROUND_BASE + i,
            seed=kw["seed"], chunk=chunk, theta=kw["theta"],
            sigma=kw["sigma"], frontier=f, n_levels=n_levels)
        cell = torch.where(done, cell, ncell)
        rel = torch.where(done, rel, nrel)
        done = done | (rel >= last) | ~nvalid
    leaf = torch.clamp(cell.to(torch.int64), 0, members.shape[0] - 1)
    mem = members[leaf]
    msafe = torch.where(mem >= 0, mem, 0).to(torch.int64)
    mvalid = (mem >= 0) & (gid_base + msafe != gid[:, None])
    w = torch.where(mvalid, vac[msafe], 0.0) * tv._gauss(
        tv.pairwise_d2(x, npos[msafe]), kw["sigma"])
    member_draws = int((mvalid & (w > 1e-12)).sum())
    return {"queries": q, "rounds": rounds, "node_evaluations": evals,
            "frontier_draws": draws, "member_draws": member_draws,
            "subround_entries": entries}


def k2_compare_and_time(cfg, inputs=None, label="K2 bh_traverse"):
    """K2 against its plain version on every row, its times and bound, at
    the R=1 main path's shapes or at ``inputs`` (``k2_inputs_ranks``)."""
    from repro_torch.connectome.traverse import phase_b_core
    from repro_torch.kernels import bh_traverse as bt
    args, kw, widths = inputs or k2_inputs(cfg)
    kt, kok, kd = bt.bh_traverse(*args, **kw, widths=widths)
    pt, pok, pd = phase_b_core(*args, **kw)
    q = kt.shape[0]
    diff_t = int((kt != pt).sum())
    diff_d = int((kd != pd).sum())
    diff_ok = int((kok != pok).sum())
    max_abs = float(max((kt - pt).abs().max(), (kd - pd).abs().max()))
    ms = cuda_ms(lambda: bt.bh_traverse(*args, **kw, widths=widths), reps=5)
    dev_ms = device_ms(lambda: bt.bh_traverse(*args, **kw, widths=widths), 5)
    plain_ms = cuda_ms(lambda: phase_b_core(*args, **kw), reps=1)
    n_levels = kw["n_levels"]
    rounds = int(kd.sum())
    m = int(args[2].shape[1])
    # the bound of earlier slices: 8 node evaluations a sub-round, every
    # sub-round, and 8 frontier and M member draws
    old_draws = rounds * 8 + q * m
    old = bound(sum(a.numel() * a.element_size() for a in args[:9]) + q * 9,
                old_draws * HASH_OPS,
                rounds * n_levels * 8 * NODE_OPS_EARLIER
                + old_draws * (NODE_OPS_EARLIER + GUMBEL_LOG_OPS))
    # the work this search needs (k2_work): each frontier entry's statistics
    # once, a Gumbel draw (a Threefry and two logs) for each valid nonempty
    # settled entry and valid member
    work = k2_work(args, kw)
    draws = work["frontier_draws"] + work["member_draws"]
    nbytes = (sum(a.numel() * a.element_size() for a in args[2:9])
              + 16 * sum(widths) + q * 9)
    b = bound(nbytes, draws * HASH_OPS,
              work["node_evaluations"] * NODE_OPS + draws * GUMBEL_LOG_OPS)
    invalid = int((~args[8]).sum())
    emit({"phase": "check", "kernel": label,
          "shape": {"Q": q, "L": int(args[0].shape[0]),
                    "C": int(args[0].shape[1]), "widths": list(widths),
                    "M": m, "F": cfg.frontier_cap, "gid_base": args[10]},
          "invalid_queries": invalid, "invalid_share": invalid / q,
          "tolerance": "bit-equal (target_gid, ok, depth on every row)",
          "target_mismatches": diff_t, "depth_mismatches": diff_d,
          "ok_mismatches": diff_ok, "found": int(kok.sum()),
          "work": work, "bound_ms": b[0], "bound_by": b[1],
          "bound_ms_earlier_slices": old[0]})
    if diff_t or diff_d or diff_ok:
        fail(f"K2: {diff_t} targets / {diff_d} depths / {diff_ok} ok flags "
             f"differ from the plain version")
    return ms, dev_ms, plain_ms, b, max(diff_t, diff_d, diff_ok), max_abs


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


def check_k3(cfg, num_ranks: int = 1, rank: int = 0):
    """K3 at a path's shapes: the neurons of CONFIG, the rank's leaf block
    (n_leaf = cells_per_rank x 8^local_levels: 8^4 at R=1, rank 3's two
    branch cells at R=4); one device launch a call, counted in
    csrc/morton_sort.cu."""
    import torch
    from repro_torch.connectome import tree as ctree
    from repro_torch.core import engine
    from repro_torch.kernels import radix_sort as rs
    pos = engine.init_state(cfg, rank, num_ranks, device=DEV).positions
    leaf_level, n_leaf, base_cell = ctree._tree_geometry(rank, cfg,
                                                         num_ranks)
    base = base_cell * 8 ** cfg.local_levels
    kw = dict(leaf_level=leaf_level, n_leaf=n_leaf)
    rs.morton_device_launches(reset=True)
    got = rs.morton_sort(pos, base, **kw)
    torch.cuda.synchronize()
    per_call = rs.morton_device_launches(reset=True)
    want = rs.morton_sort_plain(pos, base, **kw)
    n = pos.shape[0]
    diff = _check_exact("K3 morton_sort", got, want,
                        {"n": n, "R": num_ranks, "rank": rank,
                         "base_cell": base_cell, "leaf_level": leaf_level,
                         "n_leaf": n_leaf, "max_slot": int(got[1].max()),
                         "device_launches_per_call": per_call})
    if per_call != 1:
        fail(f"K3: {per_call} device launches in one call")
    ms = cuda_ms(lambda: rs.morton_sort(pos, base, **kw), reps=5)
    dev_ms = device_ms(lambda: rs.morton_sort(pos, base, **kw), 5)
    plain_ms = cuda_ms(lambda: rs.morton_sort_plain(pos, base, **kw), reps=1)
    nbytes = n * 3 * 4 + 4 + 2 * n * 4        # the positions in, rel and slot
    return ms, plain_ms, bound(nbytes, n * MORTON_OPS), diff, dev_ms, \
        per_call


def _apply_bytes(n, s, qm, qr):
    """The table in and out, messages (9 B), requests (9 B and, fed, their
    4-byte priority; the keyed mode draws it), vacancies and the accept
    mask once each."""
    return 2 * n * s * 4 + qm * 9 + qr * 9 + qr + n * 4


def check_k4(cfg, num_ranks: int = 1):
    """K4's two launch shapes on the scenario path, on random full-width
    inputs: a drain at the lesion's message count (no request side, null
    pointers) and the accept of a full request buffer (no message side) in
    the keyed mode the path runs (the priorities drawn inside K4 from the
    accept key's words), held bitwise against K4 fed
    ``kr.edge_priority``'s priorities and against the plain accept; at R
    ranks the messages and requests of all R ranks' buffers (R x cap each)
    and partner gids of every rank. At R=1 also the fused apply's accept
    and drain under a ``FillCounter``: no placeholder operand filled."""
    import torch
    from repro_torch import prng
    from repro_torch.connectome import routing
    from repro_torch.connectome.synapses import compact
    from repro_torch.kernels import _build
    from repro_torch.kernels import retract as kr
    from repro_torch.kernels import synapse_apply as sa
    from repro_torch.sim import registry
    n, s = cfg.neurons_per_rank, cfg.max_synapses
    g = torch.Generator(device=DEV).manual_seed(6)
    i32 = torch.int32
    edges = torch.randint(0, num_ranks * n, (n, s), generator=g, device=DEV,
                          dtype=i32)
    edges = compact(torch.where(torch.rand(n, s, generator=g, device=DEV)
                                < 0.4, -1, edges))
    qm = num_ranks * routing.cap_deletions(cfg, True)
    qr = num_ranks * routing.cap_requests(cfg, num_ranks)
    live = torch.nonzero(edges >= 0)
    pick = live[torch.randint(0, live.shape[0], (qm,), generator=g,
                              device=DEV)]
    mlid = pick[:, 0].to(i32)
    mgid = edges[pick[:, 0], pick[:, 1]]
    mval = torch.rand(qm, generator=g, device=DEV) < 0.9
    req = (torch.randint(0, n, (qr,), generator=g, device=DEV, dtype=i32),
           torch.randint(0, num_ranks * n, (qr,), generator=g, device=DEV,
                         dtype=i32),
           torch.rand(qr, generator=g, device=DEV) < 0.9)
    vac = torch.rand(n, generator=g, device=DEV) * 6
    key = prng.split_words(prng.fold_in_words(prng.key_words(cfg.seed + 2),
                                              5), 3)[2]
    none3 = (None,) * 3
    drain = ((edges, mlid, mgid, mval, None, None, None, None, None), {})
    accept = ((edges, *none3, *req, None, vac), {"key": key})
    res = {}
    for name, (args, kw), q in (("drain", drain, (qm, 0)),
                                ("accept", accept, (0, qr))):
        sa.device_launches(reset=True)
        got = sa.synapse_apply(*args, **kw)
        torch.cuda.synchronize()
        per_call = sa.device_launches(reset=True)
        want = sa.synapse_apply_plain(*args, **kw)
        shape = {"n": n, "S": s, "R": num_ranks, "qm": q[0], "qr": q[1],
                 "changed_rows": int((got[0] != edges).any(1).sum()),
                 "accepted": int(got[1].sum()),
                 "device_launches_per_call": per_call}
        diff = _check_exact(f"K4 synapse_apply ({name})", got, want, shape)
        if per_call != 1:
            fail(f"K4 ({name}): {per_call} device launches in one call")
        extra = {}
        if name == "accept":
            # the same accept fed the standalone priority kernel's draws
            prio = kr.edge_priority(key, req[1], req[0], req[2])
            fed_args = (edges, *none3, *req, prio, vac)
            _check_exact(f"K4 keyed == K4 fed edge_priority (R={num_ranks})",
                         got, sa.synapse_apply(*fed_args), shape)
            extra = {"fed_ms": cuda_ms(lambda: sa.synapse_apply(*fed_args),
                                       reps=5),
                     "fed_device_ms": device_ms(
                         lambda: sa.synapse_apply(*fed_args), 5)}
        ms = cuda_ms(lambda: sa.synapse_apply(*args, **kw), reps=5)
        dev_ms = device_ms(lambda: sa.synapse_apply(*args, **kw), 5)
        plain_ms = cuda_ms(lambda: sa.synapse_apply_plain(*args, **kw),
                           reps=1)
        ops = (n * s + q[0] + q[1]) * APPLY_OPS
        if name == "accept":   # the keyed draws: three Threefry a request
            ops += int(req[2].sum()) * 3 * HASH_OPS
        res[name] = (ms, plain_ms, bound(_apply_bytes(n, s, *q), ops), diff,
                     dev_ms, per_call, extra)
    if num_ranks == 1:
        fused = registry.resolve("apply", "fused")
        before = kr.priority_launches.count
        with _build.FillCounter() as fills:
            fused.accept(*req, vac, edges, key)
            fused.deletion(edges, mlid, mgid, mval)
        torch.cuda.synchronize()
        drawn = kr.priority_launches.count - before
        emit({"phase": "fused_apply_operands", "fills": fills.calls,
              "edge_priority_launches": drawn})
        if fills.calls or drawn:
            fail(f"the fused apply filled {fills.calls} and launched "
                 f"edge_priority {drawn} times")
    return res


def check_k5(cfg, num_ranks: int = 1, rank: int = 0):
    """K5 at the scenario path's shapes: the flattened (n*S,) kill pairs of
    a lesion-sized retraction (half the edges) into the lesion cap, so the
    drop path runs; at R ranks rank ``rank``'s pairs, partner gids on every
    rank, into R buckets; one device launch a call, counted in
    csrc/synapse_apply.cu. Also the device time of the caller's two (n*S,)
    operands, the where() and the broadcast copy before the kernel."""
    import torch
    from repro_torch.connectome import routing
    from repro_torch.kernels import synapse_apply as sa
    n, s = cfg.neurons_per_rank, cfg.max_synapses
    g = torch.Generator(device=DEV).manual_seed(7)
    m = n * s
    other = torch.randint(0, num_ranks * n, (m,), generator=g, device=DEV,
                          dtype=torch.int32)
    other = torch.where(torch.rand(m, generator=g, device=DEV) < 0.5, -1,
                        other)
    mine = rank * n + torch.arange(m, device=DEV, dtype=torch.int32) // s
    cap = routing.cap_deletions(cfg, True)
    kw = dict(n=n, num_ranks=num_ranks, cap=cap)
    sa.route_device_launches(reset=True)
    got = sa.route_build(other, mine, **kw)
    torch.cuda.synchronize()
    per_call = sa.route_device_launches(reset=True)
    want = sa.route_build_plain(other, mine, **kw)
    diff = _check_exact("K5 route_build", got, want,
                        {"entries": m, "R": num_ranks, "rank": rank,
                         "cap": cap, "valid": int((other >= 0).sum()),
                         "to_other_ranks": int(((other >= 0) & (
                             other // n != rank)).sum()),
                         "placed_per_bucket": (got[0][..., 0] >= 0).sum(1)
                         .tolist(),
                         "dropped": float(got[1][0]),
                         "device_launches_per_call": per_call})
    if per_call != 1:
        fail(f"K5: {per_call} device launches in one call")
    ms = cuda_ms(lambda: sa.route_build(other, mine, **kw), reps=5)
    dev_ms = device_ms(lambda: sa.route_build(other, mine, **kw), 5)
    plain_ms = cuda_ms(lambda: sa.route_build_plain(other, mine, **kw),
                       reps=1)
    nbytes = 2 * m * 4 + cap * 2 * 4 + 4      # pairs in, buffer and count out
    # the caller's two (n*S,) operands (connectome/synapses.py::_route_fused)
    kill = torch.rand(n, s, generator=g, device=DEV) < 0.5
    edges = other.reshape(n, s)
    col = torch.arange(n, dtype=torch.int32, device=DEV)[:, None]
    inputs_ms = device_ms(lambda: (
        torch.where(kill, edges, -1).reshape(-1),
        torch.broadcast_to(col, kill.shape).reshape(-1)), 5)
    return ms, plain_ms, bound(nbytes, m * ROUTE_OPS), diff, dev_ms, \
        per_call, inputs_ms


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


def k8_call_split(x0, cfg, params, reps: int = 2000) -> dict:
    """Host time of a K8 call by part (ms, mean of ``reps`` calls, the
    host clock around each): the input checks, the parameters packed, the
    one output allocation, the struct and the launch. Each call launches
    the kernel; the card keeps up with the host, so the parts are host
    time."""
    import torch
    from repro_torch.kernels import neuron_step as ns
    pc = time.perf_counter
    index = x0[0].get_device()
    parts = [0.0] * 4
    torch.cuda.synchronize()
    for _ in range(reps):
        t0 = pc()
        ins, n = ns._inputs(x0, index)
        t1 = pc()
        keep = []
        tail, _ = ns._tail(cfg, params, index, keep)
        t2 = pc()
        outs, base, step = ns._outputs(n, ins[0].device)
        t3 = pc()
        ns._launch(tail, ins, n, base, step, index)
        t4 = pc()
        for k, dt in enumerate((t1 - t0, t2 - t1, t3 - t2, t4 - t3)):
            parts[k] += dt
    torch.cuda.synchronize()
    names = ("checks", "constants", "allocation", "struct_and_launch")
    split = {k: v / reps * 1e3 for k, v in zip(names, parts)}
    split["sum"] = sum(split.values())
    return split


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

    # ---- K8: one rate window per variant, bit-equal; the empty kernel of
    # its grid and where a call's host time goes -------------------------
    n = cfg.neurons_per_rank
    for name, params in inp["k8_params"].items():
        got = out["K8", name]
        plain = neuron_window(ns.neuron_step_plain, inp, cfg, params)
        again = neuron_window(ops.fused_neuron_step, inp, cfg, params)
        exact = _same(got, plain)
        x0 = (*inp["k8_state"], inp["k8_input"][0])
        ms = cuda_ms(lambda: ops.fused_neuron_step(*x0, cfg, params=params),
                     reps=200)
        plain_ms = cuda_ms(lambda: ns.neuron_step_plain(*x0, cfg,
                                                        params=params), reps=10)
        dev_ms = device_ms(lambda: ops.fused_neuron_step(*x0, cfg,
                                                         params=params), 200)
        floor_ms = device_ms(lambda: ns.floor_launch(*x0, cfg, params=params),
                             200)
        nbytes = (45 if params is None else 69) * n
        b = bound(nbytes, fp_ops=n * NEURON_STEP_OPS)
        lines.append({"kernel": "K8 neuron_step", "variant": name, "n": n,
                      "calls": cfg.rate_period, "equal": exact,
                      "deterministic": _same(got, again),
                      "spikes": int(got[6]), "ms": ms,
                      "device_ms": dev_ms, "empty_kernel_device_ms": floor_ms,
                      "plain_ms": plain_ms,
                      "bound_ms": b[0], "bound_by": b[1],
                      "call_split_ms": k8_call_split(x0, cfg, params)})
        if not exact or not _same(got, again):
            fail(f"K8 ({name}): differs from its plain version or between "
                 f"two runs")
        if name == "homogeneous":
            entries["K8"] = dict(ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
                                 bound=b, max_abs_err=0.0, library_ms=None,
                                 extra={"empty_kernel_device_ms": floor_ms,
                                        "heterogeneous_ms": None})
        else:
            entries["K8"]["extra"]["heterogeneous_ms"] = ms

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


def run_main_path(cfg, chunks: int, scenario=None, num_ranks: int = 1,
                  each=None):
    """A fresh simulator of ``num_ranks`` ranks (more than one: all in this
    process, through ``dist.LocalComm``): one warm-up chunk, then ``chunks``
    timed chunks, each ``run(1)`` (with the recorder when there is a
    scenario); ``each(sim)``, if given, after every chunk, outside the
    timing. Returns (sim, recorder, warm-up ms, per-chunk ms, per-chunk
    health flags)."""
    import torch
    from repro_torch.scenarios import observables
    from repro_torch.sim.api import Simulator
    sim = Simulator.from_config(cfg, scenario=scenario, device=DEV,
                                num_ranks=num_ranks)
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
        if each is not None:
            each(sim)
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


def fused_vs_reference(base_cfg, scenario, chunks: int, exact_kernels: bool,
                       num_ranks: int = 1):
    """Reference and fused lowerings from one seed on a small config, at
    ``num_ranks`` ranks: the counters, edge tables and (with a scenario,
    all five lowerings fused) the recorder's rows must be equal."""
    import torch
    from repro_torch.scenarios import observables
    from repro_torch.sim.api import Simulator
    fields = ("activity_impl", "connectivity_impl") if scenario is None \
        else ("activity_impl", "connectivity_impl", "tree_impl",
              "apply_impl")
    out = {}
    for impl in ("reference", "fused"):
        cfg = dataclasses.replace(base_cfg, **{f: impl for f in fields})
        sim = Simulator.from_config(cfg, scenario=scenario, device=DEV,
                                    num_ranks=num_ranks)
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
          "lowerings_fused": list(fields), "chunks": chunks,
          "ranks": num_ranks, "equal": same,
          "synapses_formed": b[0]["synapses_formed"],
          "synapses_deleted": b[0]["synapses_deleted"]})
    if not same and exact_kernels:
        fail(f"fused and reference lowerings disagree ({scenario}, "
             f"{num_ranks} ranks)")


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
    rows = sim.num_ranks * n
    finite = all(bool(torch.isfinite(x).all()) for x in (
        st.neurons.v, st.neurons.u, st.neurons.calcium, st.neurons.rate,
        st.positions))
    shapes_ok = (tuple(st.in_edges.shape) == (rows, cfg.max_synapses)
                 and tuple(st.neurons.v.shape) == (rows,))
    keys = sorted(k for k in stats if not k.startswith("launches/"))
    shown = ("synapses_formed", "synapses_deleted", "activity_spikes",
             "bh_restarts", "bh_requests", "activity_steps",
             "request_overflow")
    line = {"phase": label, "config": "CONFIG, " + ", ".join(
        f"{f}={getattr(cfg, f)!r}" for f in (
            "activity_impl", "connectivity_impl", "tree_impl",
            "apply_impl")),
        "scenario": None if scenario is None else scenario.name,
        "ranks": sim.num_ranks, "neurons_per_rank": n, "S": cfg.max_synapses,
        "chunks": len(per_chunk) + 1,
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
    phase_profile({"profile": sim2}, card)


def edge_symmetry(st, n: int):
    """On the card: the multiset of (src, tgt) pairs of all out-tables
    against the one of all in-tables (gid == global row), and the number of
    edges whose ends lie on different ranks."""
    import torch
    rows_n = st.out_edges.shape[0]
    rows = torch.arange(rows_n, device=st.out_edges.device)[:, None] \
        .expand_as(st.out_edges)
    mo, mi = st.out_edges >= 0, st.in_edges >= 0
    ko = torch.sort(rows[mo] * rows_n + st.out_edges[mo].long()).values
    ki = torch.sort(st.in_edges[mi].long() * rows_n + rows[mi]).values
    same = ko.shape == ki.shape and torch.equal(ko, ki)
    cross = int((mo & (st.out_edges // n != rows // n)).sum())
    return same, int(mo.sum()), cross


def _observe(module, name: str, probe):
    """Wrap ``module.name`` so that ``probe(args, result)`` sees every call
    (device tensors only, no wait); returns the undo."""
    orig = getattr(module, name)

    def wrapped(*args, **kw):
        out = orig(*args, **kw)
        probe(args, out)
        return out
    setattr(module, name, wrapped)
    return lambda: setattr(module, name, orig)


def _rank_of_thread() -> int:
    """The rank whose code runs in this thread (``dist.LocalComm`` names
    its threads ``repro-rank-<r>``)."""
    import threading
    name = threading.current_thread().name
    return int(name.rsplit("-", 1)[1]) if name.startswith("repro-rank-") \
        else 0


def multi_rank_path(cfg, scenario, card, chunks: int = 12, num_ranks: int = 4):
    """R ranks of CONFIG in this process through ``dist.LocalComm`` on the
    one card, all five lowerings fused, through the scenario's lesion, with
    the recorder: health and finite state after every chunk, edge symmetry
    over the whole network, edges across ranks, K1-K5, retraction and the
    priorities launched (counts set to 0 before the run and read after,
    the sources' device launches one a call as at R=1), and a second run
    bitwise equal, in which K5's buffers are read for messages to other
    ranks after the lesion and K2's calls for their invalid query share.
    Returns (sim of the second run, launch counts)."""
    import torch
    from repro_torch.connectome import routing
    from repro_torch.connectome import tree as ctree
    from repro_torch.core import morton
    from repro_torch.kernels import _build
    from repro_torch.kernels import activity_fused as af
    from repro_torch.kernels import bh_traverse as bt
    from repro_torch.kernels import hash as chash
    from repro_torch.kernels import leaf_sums as ls
    from repro_torch.kernels import radix_sort as rs
    from repro_torch.kernels import synapse_apply as sa
    from repro_torch.scenarios import observables
    from repro_torch.sim.api import Simulator
    _build.reset_launch_counts()
    af.device_launches(reset=True)
    sa.device_launches(reset=True)
    rs.morton_device_launches(reset=True)
    sa.route_device_launches(reset=True)
    chash.device_launches(reset=True)
    ls.device_launches(reset=True)
    chash.plain_cuda_calls(reset=True)
    ctree.plain_cuda_calls(reset=True)
    sim, rec, warm, per_chunk, flags = run_main_path(cfg, chunks - 1,
                                                     scenario, num_ranks)
    counts = _build.launch_counts()
    plain_threefry = chash.plain_cuda_calls(reset=True)
    plain_leaf = ctree.plain_cuda_calls(reset=True)
    device_counts = {"activity_window": af.device_launches(reset=True),
                     "synapse_apply": sa.device_launches(reset=True),
                     "morton_sort": rs.morton_device_launches(reset=True),
                     "route_build": sa.route_device_launches(reset=True),
                     "threefry_words": chash.device_launches(reset=True),
                     "tree_assembly": ls.device_launches(reset=True)}
    keys = check_path("multi_rank_path", sim, cfg, warm, per_chunk, flags,
                      counts, scenario=scenario, rec=rec,
                      device_counts=device_counts)
    calls = num_ranks * chunks
    # K0: init_state's three draws a rank, and phase A's Gumbel draws, one
    # a round (branch level + 1 rounds) a rank and chunk
    k0_calls = 3 * num_ranks + (morton.branch_level(num_ranks) + 1) * calls
    want = {"activity_window": calls, "morton_sort": calls,
            "synapse_apply": 3 * calls, "route_build": 2 * calls,
            "retract": 2 * calls, "edge_priority": 0,
            "threefry_words": k0_calls, "tree_assembly": calls}
    if plain_leaf:
        fail(f"the plain leaf sums ran {plain_leaf} times on CUDA tensors "
             f"on the multi-rank path")
    if plain_threefry:
        fail(f"the plain int64 Threefry ran {plain_threefry} times on CUDA "
             f"tensors on the multi-rank path")
    for name, k in want.items():
        if counts[name] != k:
            fail(f"{name} launched {counts[name]} times on the multi-rank "
                 f"path, not {k}")
    if counts["bh_traverse"] < calls:
        fail(f"K2 launched {counts['bh_traverse']} times on the multi-rank "
             f"path")
    if device_counts != {"activity_window": {"staged": calls,
                                             "streaming": 0},
                         "synapse_apply": 3 * calls, "morton_sort": calls,
                         "route_build": 2 * calls,
                         "threefry_words": k0_calls, "tree_assembly": calls}:
        fail(f"the sources counted {device_counts} device launches on the "
             f"multi-rank path, not one a call")
    sym, live, cross = edge_symmetry(sim.state, cfg.neurons_per_rank)
    hist = observables.flush(rec)

    # the second run, one run(chunks, recorder) call, K5 and K2 observed
    routed = [[] for _ in range(num_ranks)]
    k2_valid = [[] for _ in range(num_ranks)]

    def k5_probe(args, out):
        routed[_rank_of_thread()].append((out[0][..., 0] >= 0).sum(1))

    def k2_probe(args, out):
        k2_valid[_rank_of_thread()].append(args[8].sum())

    undo = [_observe(sa, "route_build", k5_probe),
            _observe(bt, "bh_traverse", k2_probe)]
    try:
        sim2 = Simulator.from_config(cfg, scenario=scenario, device=DEV,
                                     num_ranks=num_ranks)
        rec2 = observables.init_recorder(chunks, len(scenario.regions) + 1,
                                         device=DEV)
        _, rec2 = sim2.run(chunks, recorder=rec2)
    finally:
        for u in undo:
            u()
    h2 = observables.flush(rec2)
    s1, s2 = sim.stats(), sim2.stats()
    same = (torch.equal(sim.state.in_edges, sim2.state.in_edges)
            and torch.equal(sim.state.out_edges, sim2.state.out_edges)
            and torch.equal(sim.state.neurons.v, sim2.state.neurons.v)
            and all(s1[k] == s2[k] for k in keys)
            and all((hist[k] == h2[k]).all() for k in observables.FIELDS))
    # K5's live entries per destination, per rank and chunk (two calls a
    # chunk: out-table and in-table notifications)
    per_dest = torch.stack([torch.stack(r) for r in routed]).reshape(
        num_ranks, chunks, 2, num_ranks).sum(2).cpu()
    eye = torch.eye(num_ranks, dtype=torch.bool)[:, None, :]
    to_others = per_dest.masked_fill(eye, 0).sum((0, 2))       # per chunk
    first_dead = scenario.events[0].t // cfg.rate_period - 1
    q = num_ranks * routing.cap_requests(cfg, num_ranks)
    valid = torch.stack([torch.stack(v) for v in k2_valid]).cpu().double()
    invalid_share = 1.0 - valid / q                         # (R, chunks)
    emit({"phase": "multi_rank_checks", "card": card, "ranks": num_ranks,
          "plain_threefry_on_cuda": plain_threefry,
          "edge_symmetry": sym, "live_edges": live,
          "edges_across_ranks": cross, "determinism_equal": same,
          "K5_to_other_ranks_per_chunk": to_others.tolist(),
          "K5_lesion_chunk": first_dead,
          "K2_queries_per_call": q,
          "K2_invalid_share_per_chunk": invalid_share.mean(0).tolist(),
          "K2_invalid_share_min_max": [float(invalid_share.min()),
                                       float(invalid_share.max())]})
    if not sym:
        fail("multi-rank path: the out- and in-tables disagree")
    if cross <= 0:
        fail("multi-rank path: no edge crosses ranks")
    if not same:
        fail("a second run of the multi-rank path from the same seed "
             "differs")
    if int(to_others[first_dead:].sum()) <= 0:
        fail("multi-rank path: K5 routed no message to another rank after "
             "the lesion")
    return sim2, counts


def ranges_by_launch(events, dev, group=None):
    """Each host range (``record_function``) of the trace with the device
    work launched inside it: a kernel, copy or set belongs to a range when
    its launch (the runtime call, matched to it through the correlation id)
    falls inside the range and outside the ``repro.comm.wait`` ranges (a
    rank's wait for the baton) of the range's thread. Ranks run one at a
    time (``dist.LocalComm``), so while a range's rank is not waiting only
    its own thread launches, and ranks that wait for each other inside a
    collective do not take one another's kernels; launch times are the
    host's, so this holds however the trace names the launching thread.
    ``span_ms`` sums the ranges' host spans, ``wait_ms`` the waits inside
    them. Summed by range name, or by ``group(range event)``."""
    import bisect
    import collections
    dur = {e.get("args", {}).get("correlation"): e["dur"] for e in dev}
    launches = sorted((e["ts"], dur[c]) for e in events
                      if e.get("cat") in ("cuda_runtime", "cuda_driver")
                      for c in (e.get("args", {}).get("correlation"),)
                      if c is not None and c in dur)
    starts = [t for t, _ in launches]
    total = [0.0]                  # prefix sums of the device durations
    for _, d in launches:
        total.append(total[-1] + d)

    def work(x, y):
        """(device us, launches) launched in [x, y)."""
        i, j = bisect.bisect_left(starts, x), bisect.bisect_left(starts, y)
        return total[j] - total[i], j - i

    ann = [e for e in events if e.get("cat") == "user_annotation"]
    waits = collections.defaultdict(list)
    for e in ann:
        if e["name"] == "repro.comm.wait":
            waits[(e["pid"], e["tid"])].append((e["ts"], e["ts"] + e["dur"]))
    out = {}
    for r in ann:
        a, b = r["ts"], r["ts"] + r["dur"]
        if r["name"] == "repro.comm.wait":
            device, count, waited = 0.0, 0, r["dur"]
        else:
            device, count = work(a, b)
            waited = 0.0
            for x, y in waits[(r["pid"], r["tid"])]:
                if a <= x < b:
                    d, k = work(x, min(y, b))
                    device, count = device - d, count - k
                    waited += min(y, b) - x
        acc = out.setdefault(r["name"] if group is None else group(r),
                             {"count": 0, "span_ms": 0.0, "wait_ms": 0.0,
                              "device_ms": 0.0, "launches": 0})
        acc["count"] += 1
        acc["span_ms"] += r["dur"] / 1e3
        acc["wait_ms"] += waited / 1e3
        acc["device_ms"] += device / 1e3
        acc["launches"] += count
    return out


def phase_profile(sims, card, trace=None):
    """One more chunk of each simulator of ``sims`` ({phase name:
    simulator}) under torch.profiler, all in one session, every thread
    profiled (the ranks of a multi-rank simulator run in threads of their
    own; a later session sees no launches from new rank threads, so every
    multi-rank chunk is profiled in the first session that has threads).
    Each chunk runs inside a ``chip_smoke.<phase>`` range of its own, which
    cuts the exported Chrome trace (build/chip_smoke_<trace>_trace.json)
    into windows. For each: the device busy time (kernels, copies, memsets)
    against the chunk's wall time, the device time inside each phase range
    (summed over the ranks' ranges of one name, ``count`` of them), the
    ranges with the device work their threads launched
    (``ranges_by_launch``), and the kernels that take the most device time.
    The profiler slows the host, so the wall time here is longer than the
    unprofiled chunk's. Returns {phase: (the window's events, its device
    events, the chunk's wall ms)}."""
    import collections
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    torch.cuda.synchronize()
    every_thread = torch._C._profiler._ExperimentalConfig(
        profile_all_threads=True)
    walls = {}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 experimental_config=every_thread) as prof:
        for phase, sim in sims.items():
            with record_function(f"chip_smoke.{phase}"):
                t0 = time.perf_counter()
                sim.step()
                torch.cuda.synchronize()
                walls[phase] = (time.perf_counter() - t0) * 1e3
    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "build")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir,
                        f"chip_smoke_{trace or next(iter(sims))}_trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        all_events = json.load(f)["traceEvents"]
    out = {}
    for phase, sim in sims.items():
        w = next(e for e in all_events if e.get("cat") == "user_annotation"
                 and e["name"] == f"chip_smoke.{phase}")
        lo, hi = w["ts"], w["ts"] + w["dur"]
        events = [e for e in all_events if "ts" in e and lo <= e["ts"] <= hi
                  and e is not w]
        dev = [e for e in events
               if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
        busy_ms = sum(e["dur"] for e in dev) / 1e3
        ranges = {}
        for r in events:
            if r.get("cat") == "gpu_user_annotation":
                a, b = r["ts"], r["ts"] + r["dur"]
                inside = [e["dur"] for e in dev if a <= e["ts"] < b]
                acc = ranges.setdefault(r["name"], {
                    "span_ms": 0.0, "device_ms": 0.0, "launches": 0,
                    "count": 0})
                acc["span_ms"] += r["dur"] / 1e3
                acc["device_ms"] += sum(inside) / 1e3
                acc["launches"] += len(inside)
                acc["count"] += 1
        by_name = collections.defaultdict(lambda: [0.0, 0])
        for e in dev:
            by_name[e["name"][:80]][0] += e["dur"] / 1e3
            by_name[e["name"][:80]][1] += 1
        top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
        launched = collections.Counter(
            (e["pid"], e["tid"]) for e in events
            if e.get("cat") in ("cuda_runtime", "cuda_driver"))
        by_launch = ranges_by_launch(events, dev)
        emit({"phase": phase, "card": card,
              "scenario": getattr(sim.scenario, "name", None),
              "chunk": sim.state.chunk - 1, "chunk_wall_ms": walls[phase],
              "device_busy_ms": busy_ms,
              "device_idle_share": (1.0 - busy_ms / walls[phase])
              if dev else None,
              "chunk_device_launches": len(dev),
              "tree_build": by_launch.get("repro.conn.tree_build"),
              "ranks": sim.num_ranks, "ranges": ranges,
              "ranges_by_launch": by_launch,
              "launch_calls_by_thread": sorted(launched.values()),
              "top_device": [{"name": k, "ms": v[0], "launches": v[1]}
                             for k, v in top]})
        out[phase] = (events, dev, walls[phase])
    return out


# ------------------------------------------------ the paper's comparisons
def hash_draw_cases(cfg, num_ranks: int = 4, rank: int = 3):
    """K0's counter-hash draws at the comparison paths' shapes: phase A's
    Gumbel over (n, F) = (65,536, 64) in the outer layout (rank ``rank``'s
    (n, 1) gid column against a (1, F) counter row, one round), the old
    spike path's background noise (NORMAL over (n,) gids, one step) and K1's
    plain remote-spike uniforms (UNIT over (n, S) edge ids). Each: (kernel
    call, plain call, bytes, integer and float operations)."""
    import torch
    from repro_torch.kernels import hash as chash
    n, f, s = cfg.neurons_per_rank, cfg.frontier_cap, cfg.max_synapses
    gids = rank * n + torch.arange(n, dtype=torch.int32, device=DEV)
    ctr = chash.bh_ctr(2, 0, torch.arange(f, device=DEV))[None, :]
    g64 = gids.to(torch.int64)
    edge_id = g64[:, None] * s + torch.arange(s, device=DEV)
    seed, gstep = cfg.seed, 2 * cfg.rate_period + 7
    col = gids[:, None]
    return {
        "gumbel (n, F)": (
            lambda: chash.gumbel(seed, chash.BH_DOMAIN, ctr, col),
            lambda: chash.gumbel_plain(seed, chash.BH_DOMAIN, ctr, col),
            4 * n + 8 * f + 4 * n * f, n * f * (HASH_OPS + GUMBEL_EPILOGUE[0]),
            n * f * GUMBEL_EPILOGUE[1]),
        "normal (n,)": (
            lambda: chash.normal(seed, chash.NOISE_DOMAIN, gstep, g64),
            lambda: chash.normal_plain(seed, chash.NOISE_DOMAIN, gstep, g64),
            8 * n + 4 * n, n * (HASH_OPS + NORMAL_EPILOGUE[0]),
            n * NORMAL_EPILOGUE[1]),
        "uniform (n, S)": (
            lambda: chash.uniform(seed, chash.SPIKE_DOMAIN, gstep, edge_id),
            lambda: chash.uniform_plain(seed, chash.SPIKE_DOMAIN, gstep,
                                        edge_id),
            8 * n * s + 4 * n * s, n * s * (HASH_OPS + UNIT_EPILOGUE[0]),
            n * s * UNIT_EPILOGUE[1]),
    }


def check_hash_draws(cfg):
    """K0's GUMBEL, NORMAL and UNIT modes against the plain int64 Threefry
    composition on the card: bit-equal, one device launch a call (counted in
    csrc/hash_words.cu), timed beside the bound. Returns the lines by
    case."""
    import torch
    from repro_torch.kernels import hash as chash
    lines = {}
    for name, (kernel, plain, nbytes, iops, fops) in hash_draw_cases(
            cfg).items():
        chash.device_launches(reset=True)
        out = kernel()
        torch.cuda.synchronize()
        launched = chash.device_launches(reset=True)
        want = plain()
        exact = torch.equal(out, want)
        ms = cuda_ms(kernel, reps=20)
        dev_ms = device_ms(kernel, 20)
        plain_ms = cuda_ms(plain, reps=3)
        b = bound(nbytes, iops, fops)
        lines[name] = {"elements": out.numel(), "equal": exact,
                       "max_abs_err": float((out - want).abs().max()),
                       "device_launches_per_call": launched, "ms": ms,
                       "device_ms": dev_ms, "plain_ms": plain_ms,
                       "bound_ms": b[0], "bound_by": b[1]}
        if not exact or launched != 1:
            fail(f"K0 {name}: equal {exact}, {launched} device launches in "
                 f"one call (not 1)")
    emit({"phase": "check", "kernel": "K0 counter-hash draws",
          "tolerance": "bit-equal", "draws": lines})
    return lines


def k1_sparse_inputs(cfg, num_ranks: int = 4, rank: int = 1):
    """K1's sparse operand at rank ``rank`` of ``num_ranks``'s shapes: the
    rows of ``k1_inputs`` with their remote sources drawn from fewer unique
    gids than the registry holds (``cap_subs``, 32,768 at CONFIG and R=4),
    the registry and slot remap from ``core.spikes.build_subscriptions``
    and the compact buffer holding the dense table's rates. Returns
    (state, edges, weights, dense rates, buffer, slots, izh, subscribed
    sources, overflow)."""
    import torch
    from repro_torch.connectome import routing
    from repro_torch.core import spikes
    state, edges, w, rates, izh = k1_inputs(cfg, num_ranks, rank)
    n = cfg.neurons_per_rank
    cap = routing.cap_subs(cfg, num_ranks)
    g = torch.Generator(device=DEV).manual_seed(2)
    idx = torch.randint(0, (num_ranks - 1) * n, (cap * 7 // 8,),
                        generator=g, device=DEV, dtype=torch.int32)
    pool = idx + n * (idx >= rank * n).to(torch.int32)   # other ranks' gids
    pick = pool[torch.randint(0, pool.shape[0], edges.shape, generator=g,
                              device=DEV)]
    remote = (edges >= 0) & (edges // n != rank)
    edges = torch.where(remote, pick, edges)
    subs, slots, ovf = spikes.build_subscriptions(edges, rank, n, cap)
    valid = subs != spikes.NO_SUB
    gi = torch.where(valid, subs, 0).to(torch.int64)
    buf = torch.where(valid, rates[gi // n, gi % n], 0.0)
    return state, edges, w, rates, buf, slots, izh, int(valid.sum()), \
        float(ovf)


def k1_sparse_check(cfg, num_ranks: int = 4, rank: int = 1):
    """K1 with the sparse exchange's operand against its plain version and
    against K1 on the dense table holding the same rates, one window each,
    bit-equal (integer weights); then its times and bound. Returns (ms,
    device ms, plain ms, bound, max abs err)."""
    import torch
    from repro_torch.kernels import activity_fused as af
    state, edges, w, rates, buf, slots, izh, subscribed, ovf = \
        k1_sparse_inputs(cfg, num_ranks, rank)
    kw = dict(seed=cfg.seed, num_steps=cfg.rate_period, izh=izh,
              ca_consts=(cfg.calcium_decay, cfg.calcium_beta))
    bg = (cfg.background_mean, cfg.background_std)
    args = (state, edges, w, buf, *bg, 2, rank)
    af.device_launches(reset=True)
    kst, kspk = af.activity_window(*args, rate_slots=slots, **kw)
    torch.cuda.synchronize()
    per_window = af.device_launches(reset=True)
    pst, pspk = af.window_plain(*args, rate_slots=slots, **kw)
    dst, dspk = af.activity_window(state, edges, w, rates, *bg, 2, rank,
                                   **kw)
    torch.cuda.synchronize()
    exact = all(torch.equal(a, b) for a, b in zip(kst, pst)) and \
        torch.equal(kspk, pspk)
    dense = all(torch.equal(a, b) for a, b in zip(kst, dst)) and \
        torch.equal(kspk, dspk)
    err = max(float((a.float() - b.float()).abs().max())
              for a, b in zip(kst, pst))
    n, s, steps = cfg.neurons_per_rank, cfg.max_synapses, cfg.rate_period
    valid = int((edges >= 0).sum())
    remote = int(((edges >= 0) & (edges // n != rank)).sum())
    call = lambda: af.activity_window(*args, rate_slots=slots, **kw)  # noqa
    ms = cuda_ms(call, reps=5)
    dev_ms = device_ms(call, 5)
    plain_ms = cuda_ms(lambda: af.window_plain(*args, rate_slots=slots, **kw),
                       reps=1)
    # the bytes of k1_timing with the (subs_cap,) buffer and the (n, S)
    # slots in place of the (R, n) table
    nbytes = (25 * n + 4 * n * s + 4 * n + 4 * buf.numel() + 4 * n * s
              + 8 * n + 24 * n + 25 * n + 4 * steps)
    b = bound(nbytes, steps * (n * HASH_OPS + valid * SLOT_OPS
                               + remote * HASH_OPS), steps * n * NEURON_OPS)
    emit({"phase": "check", "kernel": "K1 activity_window (sparse rates)",
          "shape": {"n": n, "S": s, "R": num_ranks, "rank": rank,
                    "subs_cap": int(buf.numel()), "steps": steps},
          "remote_edges": remote,
          "slots_with_a_subscription": int((slots >= 0).sum()),
          "subscribed_sources": subscribed,
          "subscription_overflow": ovf,
          "tolerance": "bit-equal (integer weights), also to K1 on the dense "
                       "table of the same rates",
          "equal": exact, "equals_dense": dense, "max_abs_err": err,
          "device_launches_per_window": per_window, "ms": ms,
          "device_ms": dev_ms, "plain_ms": plain_ms, "bound_ms": b[0],
          "bound_by": b[1]})
    if not exact or not dense or sum(per_window.values()) != 1:
        fail(f"K1 sparse: equal {exact}, equal to dense {dense}, "
             f"{per_window} device launches in one window")
    return ms, dev_ms, plain_ms, b, err


def k2_inputs_global(cfg, num_ranks: int = 4, rank: int = 3, chunk: int = 2):
    """K2 as rank ``rank`` of ``num_ranks`` runs it under the old
    algorithm: the global tree of every rank's subtree and leaf data as
    ``routing.formation_old`` downloads it (member gids global, gid_base 0,
    the R*n neurons' positions), queried by the rank's searchers from their
    phase-A branch cells."""
    import torch
    from repro_torch.connectome import traverse
    from repro_torch.connectome import tree as ctree
    from repro_torch.core import engine, morton
    n = cfg.neurons_per_rank
    sts = [engine.init_state(cfg, r, num_ranks, device=DEV)
           for r in range(num_ranks)]
    trees = [ctree.build_local_tree(st.positions, st.neurons.de_elements, r,
                                    cfg, num_ranks)
             for r, st in enumerate(sts)]
    counts = tuple(torch.cat([t.counts[k] for t in trees])
                   for k in range(len(trees[0].counts)))
    cents = tuple(torch.cat([t.centroids[k] for t in trees])
                  for k in range(len(trees[0].counts)))
    members = torch.cat([torch.where(t.leaf_members >= 0,
                                     t.leaf_members + r * n, -1)
                         for r, t in enumerate(trees)])
    top = ctree.build_top_tree(counts[0], cents[0], num_ranks)
    pos = sts[rank].positions
    gids = rank * n + torch.arange(n, dtype=torch.int32, device=DEV)
    start, valid = traverse.phase_a(top, pos, gids, cfg, num_ranks,
                                    chunk=chunk)
    stacked = traverse.stack_levels(counts, cents,
                                    morton.branch_level(num_ranks))
    kw = dict(seed=cfg.seed, sizes=stacked.sizes, theta=cfg.theta,
              sigma=cfg.sigma, frontier=cfg.frontier_cap,
              n_levels=cfg.local_levels + 1)
    args = (stacked.counts, stacked.centroids, members,
            torch.cat([st.positions for st in sts]),
            torch.cat([st.neurons.de_elements for st in sts]), pos, start,
            gids, valid, chunk, 0)
    return args, kw, tuple(c.shape[0] for c in counts)


# the cell: CONFIG at R=4, all five lowerings fused, lesion_rewiring with its
# lesion at step 250 (inside every run), requests_cap_factor = R (cap = n:
# no formation request is dropped, which old == new needs); each run changes
# one field
COMPARISON_RUNS = (
    ("a", {}),
    ("b", {"connectivity_alg": "old"}),
    ("c", {"rate_exchange": "sparse"}),
    ("d", {"spike_alg": "old", "activity_impl": "reference"}),
)
EXCHANGE_RANGE = {"a": "repro.comm.rates", "b": "repro.comm.rates",
                  "c": "repro.comm.subscriptions", "d": "repro.comm.spikes"}
BYTE_COUNTERS = ("formation_requests", "tree_nodes_downloaded", "rates_sent",
                 "subscription_requests", "subscription_overflow",
                 "spikes_sent")
PATH_KERNELS = ("threefry_words", "activity_window", "bh_traverse",
                "morton_sort", "synapse_apply", "route_build", "retract",
                "tree_assembly")


def comparison_run(cfg, scenario, chunks: int, num_ranks: int):
    """One run of the comparison cell: a fresh R-rank simulator, one
    warm-up and ``chunks`` timed chunks (``run_main_path``), after every
    chunk the global edge tables and neuron fields copied to the host and
    health and finiteness read; the launch counts set to 0 before and read
    after. Returns a dict."""
    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels import hash as chash
    _build.reset_launch_counts()
    chash.mode_launches(reset=True)
    chash.plain_cuda_calls(reset=True)
    held = torch.cuda.memory_allocated()    # the earlier runs' simulators
    snaps, finite = [], []

    def keep(sim):
        st = sim.state
        finite.append(all(bool(torch.isfinite(x).all()) for x in (
            st.neurons.v, st.neurons.u, st.neurons.calcium, st.neurons.rate,
            st.positions)))
        snaps.append({"out_edges": st.out_edges.cpu(),
                      "in_edges": st.in_edges.cpu(),
                      **{f: getattr(st.neurons, f).cpu()
                         for f in st.neurons._fields}})

    sim, _, warm, per_chunk, flags = run_main_path(cfg, chunks, scenario,
                                                   num_ranks, each=keep)
    counts = _build.launch_counts()
    ring = sim.state.stats.per_chunk
    per_chunk_counters = {k: ring[k][:, :chunks + 1].cpu()
                          for k in ring}
    return {"sim": sim, "warm": warm, "per_chunk": per_chunk,
            "flags": flags, "finite": finite, "snaps": snaps,
            "counts": counts, "modes": chash.mode_launches(reset=True),
            "plain_threefry": chash.plain_cuda_calls(reset=True),
            "ring": per_chunk_counters,
            "peak_mem_gb": (torch.cuda.max_memory_allocated() - held) / 1e9}


def _same_snaps(a, b, keys=None, upto=None):
    """Whether two runs' per-chunk host snapshots are bitwise equal (over
    ``keys``, for the first ``upto`` chunks)."""
    import torch
    pairs = list(zip(a, b))[:upto]
    return len(a) == len(b) and all(
        torch.equal(x[k], y[k]) for x, y in pairs for k in (keys or x))


def comparison_paths(base_cfg, scenario, card, chunks: int = 4,
                     chunks_old_spikes: int = 2, num_ranks: int = 4,
                     also_profile=None):
    """The paper's comparisons at CONFIG, R=4, one process: (a) the new
    algorithm with the dense exchange, (b) the old connectivity algorithm,
    (c) the sparse rate exchange, (d) the old spike exchange (on the
    reference activity lowering), in turns; then (b), (c) and (d) again.
    Fails unless (b) == (a) bitwise (edge tables, synapses formed and
    deleted, every chunk), (c) == (a) bitwise (edge tables and every neuron
    field, every chunk before a subscription overflow), every chunk of every
    run healthy and finite, the second runs bitwise equal to the first, (d)
    launches no K1, no run calls the plain int64 Threefry on a CUDA tensor,
    and every kernel of a run's path launched. Then one profiled chunk of
    each run (in one profiler session with ``also_profile``, {phase name:
    simulator}): per rank the ``repro.connectivity`` range, the exchange's
    ranges, and the two ratios of the paper's abstract."""
    import torch
    runs, second = {}, {}
    for label, change in COMPARISON_RUNS + COMPARISON_RUNS[1:]:
        cfg = dataclasses.replace(base_cfg, **change)
        k = chunks_old_spikes if label == "d" else chunks
        out = comparison_run(cfg, scenario, k, num_ranks)
        if label in runs:
            second[label] = out
            del out["sim"]
        else:
            runs[label] = out
        torch.cuda.empty_cache()
    a = runs["a"]
    checks = {}
    edges = ("out_edges", "in_edges")
    ring = {k: {key: v.sum(0).tolist() for key, v in r["ring"].items()}
            for k, r in runs.items()}
    checks["b_equals_a"] = _same_snaps(a["snaps"], runs["b"]["snaps"],
                                       edges) and all(
        torch.equal(a["ring"][c], runs["b"]["ring"][c])
        for c in ("synapses_formed", "synapses_deleted"))
    overflow = ring["c"]["subscription_overflow"]
    clean = next((i for i, v in enumerate(overflow) if v > 0),
                 len(overflow))
    checks["c_equals_a_chunks"] = clean
    checks["c_equals_a"] = _same_snaps(a["snaps"], runs["c"]["snaps"],
                                       upto=clean)
    checks["healthy"] = all(all(f == 0 for f in r["flags"]) and
                            all(r["finite"]) for r in runs.values())
    checks["second_run_equal"] = all(
        _same_snaps(runs[k]["snaps"], second[k]["snaps"])
        and all(torch.equal(runs[k]["ring"][c], second[k]["ring"][c])
                for c in runs[k]["ring"]) for k in second)
    checks["d_no_k1"] = runs["d"]["counts"]["activity_window"] == 0
    checks["no_edge_priority"] = all(
        r["counts"]["edge_priority"] == 0
        for r in (*runs.values(), *second.values()))
    checks["no_plain_threefry"] = all(
        r["plain_threefry"] == 0 for r in (*runs.values(), *second.values()))
    missing = {k: [n for n in PATH_KERNELS if r["counts"][n] == 0
                   and not (k == "d" and n == "activity_window")]
               for k, r in runs.items()}
    checks["every_kernel_launched"] = not any(missing.values())
    checks["phase_a_gumbel_launched"] = all(
        r["modes"]["gumbel"] > 0 for r in runs.values())

    # one profiled chunk of each run, last: a profiler session slows the
    # host for the rest of the process
    traces = phase_profile(
        {**(also_profile or {}),
         **{f"profile_comparison_{k}": r["sim"] for k, r in runs.items()}},
        card, "profile_multi_rank")
    prof = {}
    for k, r in runs.items():
        events, dev, wall = traces[f"profile_comparison_{k}"]
        first = {}
        for e in events:
            if e.get("cat") == "user_annotation" and \
                    e["name"] == "repro.activity":
                t = (e["pid"], e["tid"])
                first[t] = min(first.get(t, e["ts"]), e["ts"])
        # the baton starts the ranks in rank order
        rank_of = {t: i for i, t in enumerate(sorted(first, key=first.get))}
        by_rank = ranges_by_launch(
            events, dev, group=lambda e: (e["name"],
                                          rank_of.get((e["pid"], e["tid"]))))
        conn = [by_rank.get(("repro.connectivity", i), {})
                for i in range(num_ranks)]
        ex = EXCHANGE_RANGE[k]
        exch = [by_rank.get((ex, i), {}) for i in range(num_ranks)]
        prof[k] = {
            "chunk_wall_ms": wall,
            "connectivity_per_rank": conn,
            "connectivity_device_ms": sum(c.get("device_ms", 0.0)
                                          for c in conn),
            "connectivity_own_host_ms": sum(
                c.get("span_ms", 0.0) - c.get("wait_ms", 0.0) for c in conn),
            "exchange_range": ex,
            "exchange_per_rank": exch,
            "exchange_span_ms": sum(c.get("span_ms", 0.0) for c in exch),
            "exchange_wait_ms": sum(c.get("wait_ms", 0.0) for c in exch),
            "exchange_own_host_ms": sum(
                c.get("span_ms", 0.0) - c.get("wait_ms", 0.0) for c in exch),
            "exchange_device_ms": sum(c.get("device_ms", 0.0) for c in exch),
            "exchange_calls": sum(c.get("count", 0) for c in exch)}
        r.pop("sim")
    for k, r in runs.items():
        emit({"phase": "comparison_run", "run": k, "card": card,
              "change": dict(COMPARISON_RUNS)[k], "ranks": num_ranks,
              "warmup_chunk_ms": r["warm"], "chunk_ms": r["per_chunk"],
              "median_chunk_ms": sorted(r["per_chunk"])[
                  len(r["per_chunk"]) // 2],
              "spread_chunk_ms": [min(r["per_chunk"]), max(r["per_chunk"])],
              "second_run_chunk_ms": second[k]["per_chunk"]
              if k in second else None,
              "peak_mem_gb": r["peak_mem_gb"],
              "health_flags_per_chunk": r["flags"],
              "byte_counters_per_chunk": {c: ring[k][c]
                                          for c in BYTE_COUNTERS},
              "request_overflow_per_chunk": ring[k]["request_overflow"],
              "synapses_formed_per_chunk": ring[k]["synapses_formed"],
              "synapses_deleted_per_chunk": ring[k]["synapses_deleted"],
              "launches": {n: r["counts"][n] for n in PATH_KERNELS},
              "draw_launches_by_mode": r["modes"],
              "plain_threefry_on_cuda": r["plain_threefry"],
              "kernels_not_launched": missing[k], **prof[k]})
    def ratio(run, key):
        den = prof["a"][key]
        return prof[run][key] / den if den > 0 else None

    ratio_conn = ratio("b", "connectivity_device_ms")
    ratio_conn_host = ratio("b", "connectivity_own_host_ms")
    ratio_spikes = ratio("d", "exchange_own_host_ms")
    ratio_spikes_dev = ratio("d", "exchange_device_ms")
    checks["ratios_measured"] = None not in (ratio_conn, ratio_conn_host,
                                             ratio_spikes)
    emit({"phase": "comparison_paths", "card": card,
          "device": torch.cuda.get_device_name(0),
          "cell": "CONFIG, R=4 in one process (dist.LocalComm), all five "
                  "lowerings fused, requests_cap_factor=4, lesion_rewiring "
                  "with the lesion at step 250",
          "chunks": {k: len(r["per_chunk"]) + 1 for k, r in runs.items()},
          "connectivity_ratio_b_over_a_device": ratio_conn,
          "connectivity_ratio_b_over_a_own_host": ratio_conn_host,
          "spike_exchange_ratio_d_over_a_own_host": ratio_spikes,
          "spike_exchange_ratio_d_over_a_device": ratio_spikes_dev,
          "note": "one card, one process: every exchange is tensor ops in "
                  "device memory, not a network; these ratios are what "
                  "this card shows, not the paper's",
          **checks})
    bad = [k for k, v in checks.items() if v is False]
    if bad:
        fail(f"comparison_paths: {bad} ({checks}; kernels not launched: "
             f"{missing})")
    return runs, second


# ---------------------------------------------------------------- workloads
LEAF_OPS = 9        # per neuron: count atomic, place, table, 4 adds and
                    # 3 products (a parent's 7 adds a cell are fewer)
R4_CHUNKS = 4       # timed chunks of each R=4 run, after one warm-up


def surrogate(cfg, num_ranks: int):
    """The hemibrain-shaped surrogate at ``num_ranks`` x CONFIG's width
    (rows in global Morton order), and its generation seconds."""
    from repro_torch.workloads import datasets as wds
    n = cfg.neurons_per_rank
    t0 = time.perf_counter()
    ds = wds.generate_hemibrain_surrogate(
        num_ranks * n, n, max_degree=cfg.max_synapses,
        fraction_excitatory=cfg.fraction_excitatory)
    return ds, time.perf_counter() - t0


def leaf_layout(cfg, positions, rank: int, num_ranks: int):
    """A rank's tree-build layout: (rel, slot) from K3, the rows whose leaf
    lies outside the rank's block (clamped into its first or last leaf),
    and the fullest leaf's occupancy."""
    import torch
    from repro_torch.connectome import tree as ctree
    from repro_torch.core import morton
    from repro_torch.kernels import radix_sort as rs
    leaf_level, n_leaf, base = ctree._tree_geometry(rank, cfg, num_ranks)
    leaf_base = base * 8 ** cfg.local_levels
    kw = dict(leaf_level=leaf_level, n_leaf=n_leaf)
    rel, slot = rs.morton_sort(positions, leaf_base, **kw)
    raw = morton.morton_encode(positions, leaf_level) - leaf_base
    clamped = int(((raw < 0) | (raw >= n_leaf)).sum())
    fullest = int(torch.bincount(rel.long(), minlength=n_leaf).max())
    return rel, slot, n_leaf, leaf_base, clamped, fullest


def check_assembly(label, cfg, positions, weights, rank: int,
                   num_ranks: int):
    """The tree assembly kernel (and K3 before it) at a path's shapes: every
    level's counts and centroids and the membership table bit-equal to the
    plain ``assemble_plain``, a second call bitwise equal, call and device
    ms, device launches a call, the plain version's ms (one call),
    ``index_add_`` of the leaf sums (the library call; not bit-equal: its
    atomics add in no fixed order) and the bound (bytes: positions,
    weight, rel and slot in; 16 B a cell of every level and the table
    out)."""
    import torch
    from repro_torch.connectome import tree as ctree
    from repro_torch.kernels import leaf_sums as ls
    from repro_torch.kernels import radix_sort as rs
    rel, slot, n_leaf, leaf_base, clamped, fullest = leaf_layout(
        cfg, positions, rank, num_ranks)
    leaf_level = ctree._tree_geometry(rank, cfg, num_ranks)[0]
    levels = cfg.local_levels
    members_cap = 4                        # build_tree's table width
    n = positions.shape[0]
    shape = {"n": n, "R": num_ranks, "rank": rank, "n_leaf": n_leaf,
             "levels": levels + 1, "members_cap": members_cap,
             "clamped_rows": clamped, "fullest_leaf": fullest}
    _check_exact(f"K3 morton_sort ({label})", (rel, slot),
                 rs.morton_sort_plain(positions, leaf_base,
                                      leaf_level=leaf_level, n_leaf=n_leaf),
                 shape)
    call = lambda: ls.assemble(positions, weights, rel, slot, n_leaf,  # noqa
                               levels, members_cap)
    ls.device_launches(reset=True)
    got = call()
    torch.cuda.synchronize()
    per_call = ls.device_launches(reset=True)
    again = call()
    flat = lambda t: (*t[0], *t[1], t[2])              # noqa: E731
    t0 = time.perf_counter()
    want = ctree.assemble_plain(positions, weights, rel, slot, n_leaf, levels,
                                members_cap)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    shape["device_launches_per_call"] = per_call
    diff = _check_exact(f"tree assembly ({label})", flat(got), flat(want),
                        shape)
    _check_exact(f"tree assembly, a second call ({label})", flat(again),
                 flat(got), shape)
    if per_call != 1:
        fail(f"tree assembly ({label}): {per_call} device launches a call")
    del want, again
    torch.cuda.empty_cache()
    ms = cuda_ms(call, reps=50)
    dev_ms = device_ms(call, 50)
    vals = torch.cat([weights[:, None], positions * weights[:, None]], 1)
    acc = torch.zeros((n_leaf, 4), dtype=torch.float32, device=DEV)
    idx = rel.long()
    lib_ms = cuda_ms(lambda: acc.index_add_(0, idx, vals), reps=10)
    cells = sum(n_leaf >> 3 * k for k in range(levels + 1))
    b = bound(n * (12 + 4 + 4 + 4) + cells * 16 + n_leaf * members_cap * 4,
              n * LEAF_OPS)
    return {"ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
            "library_ms": lib_ms, "bound_ms": b[0], "bound_by": b[1],
            "max_abs_err": diff, **shape}


def _path_checks(label, counts, plain_leaf, plain_threefry, chunks,
                 calls=None):
    """Every kernel of the path launched; K1, K3 and the tree assembly once
    a rank and chunk; ``edge_priority`` never (K4 draws the priorities); no
    plain leaf sum or plain Threefry on a CUDA tensor."""
    calls = chunks if calls is None else calls
    missing = [k for k in PATH_KERNELS if counts.get(k, 0) == 0]
    if missing:
        fail(f"{label}: {missing} never launched")
    for k in ("activity_window", "morton_sort", "tree_assembly"):
        if counts[k] != calls:
            fail(f"{label}: {k} launched {counts[k]} times, not {calls}")
    if counts["edge_priority"]:
        fail(f"{label}: edge_priority launched {counts['edge_priority']} "
             f"times; K4 draws the priorities")
    if plain_leaf or plain_threefry:
        fail(f"{label}: the plain leaf sums ran {plain_leaf} times and the "
             f"plain Threefry {plain_threefry} times on CUDA tensors")


def _reset_counts():
    from repro_torch.connectome import tree as ctree
    from repro_torch.kernels import _build
    from repro_torch.kernels import hash as chash
    _build.reset_launch_counts()
    ctree.plain_cuda_calls(reset=True)
    chash.plain_cuda_calls(reset=True)


def _read_counts():
    """(launch counts, plain leaf sums, plain Threefry) on CUDA tensors
    since ``_reset_counts``."""
    from repro_torch.connectome import tree as ctree
    from repro_torch.kernels import _build
    from repro_torch.kernels import hash as chash
    return (_build.launch_counts(), ctree.plain_cuda_calls(reset=True),
            chash.plain_cuda_calls(reset=True))


def _loaded_flags_fault(flags, ref_flags, lesion_chunk: int):
    """What is wrong with a loaded-connectome run's per-chunk health flags,
    or None. From a loaded connectome the JAX reference sets two bits
    itself (the CPU tests hold the port's flags equal to its at SMOKE
    size): conservation (the loaded edges were never counted as formed)
    and asymmetry (the surrogate's multi-edges). So the fused run's flags
    must be the all-reference lowering's, chunk by chunk, hold no other
    bit, and be 0 from the lesion's chunk on. The last is the trace
    measured at CONFIG from seed 0 (both bits clear before the lesion), not
    a property of every surrogate: at SMOKE size both bits stay set to the
    end. Nothing holds the flags at CONFIG against the JAX package
    itself."""
    from repro_torch.telemetry import metrics as tm
    loaded = tm.HEALTH_ASYMMETRY | tm.HEALTH_CONSERVATION
    if flags != ref_flags:
        return f"flags {flags}, all-reference lowering {ref_flags}"
    if any(int(f) & ~loaded for f in flags):
        return f"flags {flags}: a bit besides conservation and asymmetry"
    if any(flags[lesion_chunk:]):
        return f"flags {flags}: set after the lesion (chunk {lesion_chunk})"
    return None


def _same_state(a, b) -> bool:
    import torch
    return (torch.equal(a.out_edges, b.out_edges)
            and torch.equal(a.in_edges, b.in_edges)
            and all(torch.equal(getattr(a.neurons, f), getattr(b.neurons, f))
                    for f in a.neurons._fields))


def workloads_path(cfg, card):
    """The workloads at CONFIG on the card, all five lowerings fused:
    (1) ``run_engram`` from a loaded surrogate connectome at R=1 (the
    default spec, 12 chunks), then the same protocol again chunk by chunk
    (timed, health read) and bitwise equal, and once more under the
    all-reference lowering, whose health flags the fused run's must equal
    chunk by chunk (``_loaded_flags_fault``); (2) ``run_assimilation``, 12
    chunks through ``step_with`` (K1 once a chunk, one DynamicParams
    signature), and ``step_with(zeros)`` bitwise ``step()``; (3)
    ``from_connectome`` at R=4 (262,144 neurons, ``dist.LocalComm``) under
    the dense and the sparse exchange in lockstep, one warm-up and
    ``R4_CHUNKS`` chunks each, sparse == dense bitwise and the health
    flags 0 after every chunk;
    the tree assembly and K3 at ranks 1-3 of that layout against their
    plain versions. No plain leaf sum and no plain Threefry may run on a
    CUDA tensor. Returns (the JSON line, the leaf-sum kernel's numbers)."""
    import numpy as np
    import torch
    from repro_torch.core import engine
    from repro_torch.sim import phases
    from repro_torch.sim.api import Simulator
    from repro_torch.workloads import assimilate, engram
    n = cfg.neurons_per_rank
    line = {"phase": "workloads_path", "card": card, "config": "CONFIG, "
            "all five lowerings fused", "neurons_per_rank": n}

    # (1) engram from a loaded connectome, R=1
    ds1, gen1 = surrogate(cfg, 1)
    spec = engram.EngramSpec()
    chunks = spec.total_chunks
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    t0 = time.perf_counter()
    metrics, sim = engram.run_engram(cfg, spec, dataset=ds1, device=DEV)
    torch.cuda.synchronize()
    engram_s = time.perf_counter() - t0
    counts, plain_leaf, plain_tf = _read_counts()
    _path_checks("workloads engram", counts, plain_leaf, plain_tf, chunks)
    peak = torch.cuda.max_memory_allocated() / 1e9
    runs = {}
    for impl in ("fused", "reference"):
        sim_cfg = cfg if impl == "fused" else dataclasses.replace(
            cfg, activity_impl=impl, connectivity_impl=impl, tree_impl=impl,
            apply_impl=impl)
        s = Simulator.from_connectome(
            sim_cfg, ds1, scenario=engram.scenario(spec, cfg.rate_period),
            device=DEV)
        ms, fl = [], []
        for _ in range(chunks):
            t0 = time.perf_counter()
            s.step()
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            fl.append(s.health()["health_flags"])
        runs[impl] = (s, ms, fl)
    (sim2, per_chunk, flags), (sim_ref, _, ref_flags) = \
        runs["fused"], runs["reference"]
    again = engram.recall_metrics(sim2.state, spec) == metrics and \
        _same_state(sim.state, sim2.state)
    flag_fault = _loaded_flags_fault(
        flags, ref_flags, spec.train_chunks + spec.rest_chunks)
    finite = all(bool(torch.isfinite(x).all()) for x in (
        sim2.state.neurons.v, sim2.state.neurons.u,
        sim2.state.neurons.calcium))
    line["engram"] = {
        "dataset": {"neurons": ds1.num_neurons, "edges": ds1.num_edges,
                    "max_in_degree": int(ds1.in_degrees().max()),
                    "generate_s": gen1},
        "metrics": metrics, "run_engram_s": engram_s,
        "chunk_ms": per_chunk,
        "median_chunk_ms": sorted(per_chunk)[len(per_chunk) // 2],
        "chunk_ms_range": [min(per_chunk), max(per_chunk)],
        "peak_mem_gb": peak, "health_flags_per_chunk": flags,
        "reference_health_flags_per_chunk": ref_flags,
        "reference_state_equal": _same_state(sim2.state, sim_ref.state),
        "launches": counts, "second_run_equal": again, "finite": finite,
        "synapses_formed": sim2.stats()["synapses_formed"]}
    if not again or not finite or flag_fault:
        fail(f"workloads engram: second run equal={again}, finite={finite},"
             f" {flag_fault}")
    del sim, sim2, sim_ref, runs

    # (2) assimilation through step_with, R=1
    _reset_counts()
    t0 = time.perf_counter()
    res, asim = assimilate.run_assimilation(cfg, chunks=12, device=DEV)
    torch.cuda.synchronize()
    assim_s = time.perf_counter() - t0
    counts_a, plain_leaf, plain_tf = _read_counts()
    _path_checks("workloads assimilation", counts_a, plain_leaf, plain_tf,
                 12)
    a = Simulator.from_config(cfg, scenario=assimilate.default_scenario(),
                              device=DEV)
    b = Simulator.from_config(cfg, scenario=assimilate.default_scenario(),
                              device=DEV)
    zero_equal = _same_state(a.step(), b.step_with(
        phases.DynamicParams.zeros(2, device=DEV)))
    line["assimilation"] = {
        "chunks": 12, "abs_err_first": float(res.abs_err[0]),
        "abs_err_last": float(res.abs_err[-1]),
        "abs_err": res.abs_err.tolist(),
        "measured_driven": res.measured[:, 0].tolist(),
        "dyn_compile_count": res.compile_count, "seconds": assim_s,
        "ms_per_chunk": assim_s * 1e3 / 12, "launches": counts_a,
        "step_with_zeros_equals_step": zero_equal}
    if res.compile_count != 1 or not zero_equal or \
            not np.isfinite(res.abs_err).all():
        fail(f"workloads assimilation: {res.compile_count} signatures, "
             f"step_with(zeros) == step(): {zero_equal}")
    del asim, a, b

    # (3) from_connectome at R=4, dense and sparse in lockstep
    ds4, gen4 = surrogate(cfg, 4)
    torch.cuda.empty_cache()
    _reset_counts()
    sims, install_s = {}, {}
    for ex in ("dense", "sparse"):
        t0 = time.perf_counter()
        sims[ex] = Simulator.from_connectome(
            dataclasses.replace(cfg, rate_exchange=ex), ds4, num_ranks=4,
            device=DEV)
        torch.cuda.synchronize()
        install_s[ex] = time.perf_counter() - t0
    times = {"dense": [], "sparse": []}
    flags4 = {"dense": [], "sparse": []}
    equal = []
    for _ in range(R4_CHUNKS + 1):
        for ex, s in sims.items():
            t0 = time.perf_counter()
            s.step()
            torch.cuda.synchronize()
            times[ex].append((time.perf_counter() - t0) * 1e3)
            flags4[ex].append(s.health()["health_flags"])
        equal.append(_same_state(sims["dense"].state, sims["sparse"].state))
    counts4, plain_leaf, plain_tf = _read_counts()
    calls = 2 * 4 * (R4_CHUNKS + 1)
    _path_checks("workloads R=4", counts4, plain_leaf, plain_tf, None,
                 calls=calls)
    sparse_stats = sims["sparse"].stats()
    layout = []
    for r, st in enumerate(sims["dense"].rank_states):
        _, _, n_leaf, _, clamped, fullest = leaf_layout(
            cfg, st.positions, r, 4)
        layout.append({"rank": r, "n_leaf": n_leaf,
                       "clamped_rows": clamped, "fullest_leaf": fullest})
    line["from_connectome_R4"] = {
        "dataset": {"neurons": ds4.num_neurons, "edges": ds4.num_edges,
                    "max_in_degree": int(ds4.in_degrees().max()),
                    "generate_s": gen4},
        "install_s": install_s,
        "subs_cap_base": sims["sparse"].cfg.subs_cap_base,
        "warmup_chunk_ms": {k: v[0] for k, v in times.items()},
        "chunk_ms": {k: v[1:] for k, v in times.items()},
        "median_chunk_ms": {k: sorted(v[1:])[len(v[1:]) // 2]
                            for k, v in times.items()},
        "health_flags_per_chunk": flags4, "sparse_equals_dense": equal,
        "subscription_overflow": sparse_stats["subscription_overflow"],
        "launches": counts4, "layout": layout}
    if not all(equal) or any(flags4["dense"] + flags4["sparse"]):
        fail(f"workloads R=4: sparse == dense per chunk {equal}, flags "
             f"{flags4}")
    del sims
    torch.cuda.empty_cache()

    # the tree assembly and K3 at the paths' shapes: R=1's first tree
    # (init_state's positions and vacancies), the multi-rank path's at rank
    # 3 of 4 (n_leaf 8,192) and ranks 1-3 of the R=4 surrogate (rank 2:
    # every row clamped into one leaf)
    st = engine.init_state(cfg, 0, 1, device=DEV)
    leaf = {"R1": check_assembly("R=1", cfg, st.positions,
                                 st.neurons.de_elements, 0, 1)}
    st = engine.init_state(cfg, 3, 4, device=DEV)
    leaf["multi_rank_rank3"] = check_assembly(
        "multi-rank path, rank 3 of 4", cfg, st.positions,
        st.neurons.de_elements, 3, 4)
    del st
    g = torch.Generator(device=DEV).manual_seed(0)
    for r in (1, 2, 3):
        pos = torch.from_numpy(ds4.positions[r * n:(r + 1) * n]).to(DEV)
        w = torch.rand(n, generator=g, device=DEV) * 1.5
        leaf[f"R4_rank{r}"] = check_assembly(f"R=4 surrogate rank {r}", cfg,
                                             pos, w, r, 4)
    line["tree_assembly"] = leaf
    emit(line)
    return line, leaf


RUNNER_CHUNKS = 6    # the runner path's uninterrupted reference
CKPT_ROOT = os.path.join("build", "chip_smoke_checkpoints")


def _all_leaves_equal(a, b) -> bool:
    """Every leaf of two states bitwise equal, the chunk counter too."""
    import torch
    from repro_torch.checkpoint import manager
    la, lb = manager._flatten(a), manager._flatten(b)
    return [k for k, _ in la] == [k for k, _ in lb] and all(
        torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y
        for (_, x), (_, y) in zip(la, lb))


def _ckpt_mb(path: str) -> float:
    """The bytes of a checkpoint's files, in MB (1e6)."""
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, fs in os.walk(path) for f in fs) / 1e6


def _timed(fn):
    """(fn's result, its wall ms up to a synchronize)."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def runner_path(cfg, scenario, cmp_cfg, cmp_scenario, card):
    """The runtime at CONFIG on the card (``runtime.sim_runner``,
    ``runtime.elastic``, ``checkpoint.manager``), all five lowerings fused:

    R=1 under ``scenario``: an uninterrupted ``RUNNER_CHUNKS``-chunk
    ``Simulator.run`` (the reference, timed a chunk); a runner at
    ``ckpt_every`` 2 over the same chunks (timed an interval; the launch
    counts set to 0 before it and read after: every kernel of the path
    launched, K1, K3 and the tree assembly once a chunk); a runner
    preempted at chunk 4 and a fresh one resuming there (``restarts`` 1)
    and finishing; a runner whose state is poisoned with NaN after chunk 3
    (``rollbacks`` >= 1); each final state bitwise the reference's, every
    leaf and counter. The newest checkpoint truncated, a fresh runner
    resumes at an older step. Checkpoint MB, ``save`` (the inline device ->
    host copy and the whole write), ``restore`` and ``probe_health`` ms.

    Elastic, the comparison cell (``cmp_cfg``, ``cmp_scenario``): two
    chunks at R=4, saved, restored at R=2 (twice the neurons a rank) under
    the new and the old connectivity algorithm: the edge tables and
    positions as written, then after one chunk old == new (sorted rows,
    ``synapses_formed``) and health 0; the same from a sparse R=4
    checkpoint restored as sparse and as dense, bitwise equal after one
    chunk. Returns (the JSON line, the runner's launch counts)."""
    import shutil
    import statistics
    import torch
    from repro_torch.checkpoint import manager
    from repro_torch.runtime import chaos, elastic
    from repro_torch.runtime.sim_runner import (SimRunnerConfig,
                                                SimulationRunner)
    from repro_torch.sim.api import Simulator
    from repro_torch.telemetry import metrics as tm
    n = cfg.neurons_per_rank
    line = {"phase": "runner_path", "card": card,
            "config": "CONFIG, all five lowerings fused, lesion_rewiring",
            "neurons_per_rank": n}
    shutil.rmtree(CKPT_ROOT, ignore_errors=True)
    os.makedirs(CKPT_ROOT)
    try:
        def runner(name, **kw):
            return SimulationRunner(
                SimRunnerConfig(os.path.join(CKPT_ROOT, name), ckpt_every=2,
                                **kw), cfg=cfg, scenario=scenario,
                device=DEV)

        # the reference, a chunk at a time
        ref = Simulator.from_config(cfg, scenario=scenario, device=DEV)
        ref.init()
        ref_ms = [_timed(lambda: ref.run(1))[1]
                  for _ in range(RUNNER_CHUNKS)]
        ref_stats = ref.stats()

        def same(sim):
            return _all_leaves_equal(sim.state, ref.state) and all(
                sim.stats()[k] == ref_stats[k] for k in tm.COUNTER_KEYS)

        # a runner over the same chunks: timed by interval, its launches
        marks = []

        def mark(_):
            torch.cuda.synchronize()
            marks.append(time.perf_counter())

        _reset_counts()
        plain = runner("plain")
        plain.sim.init()
        plain.chaos_hooks.append(mark)
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        status = plain.run(RUNNER_CHUNKS)
        counts, plain_leaf, plain_tf = _read_counts()
        _path_checks("runner_path", counts, plain_leaf, plain_tf, None,
                     calls=RUNNER_CHUNKS)
        runner_ms = [(b - a) * 1e3 / 2 for a, b in zip(marks, marks[1:])]
        line["runner"] = {
            "status": status, "equal_to_reference": same(plain.sim),
            "lifecycle": dict(plain.sim.lifecycle), "launches": counts,
            "checkpoints": manager.steps_available(plain.cfg.ckpt_dir)}
        line["chunk_ms"] = {
            "sim_run": ref_ms, "sim_run_median": statistics.median(ref_ms),
            "runner_ckpt_every_2": runner_ms,
            "runner_median": statistics.median(runner_ms),
            "runner_note": "an interval of 2 chunks / 2: its stats, health "
                           "poll, probe and the checkpoint's inline copy "
                           "included"}
        if status != "done" or not line["runner"]["equal_to_reference"]:
            fail(f"runner_path: the runner gave {status!r}, equal to the "
                 f"uninterrupted run: {line['runner']['equal_to_reference']}")
        del plain

        # preempted at chunk 4, resumed by a fresh runner
        r = runner("preempt")
        r.chaos_hooks.append(chaos.preempt_after(4))
        first = r.run(RUNNER_CHUNKS)
        del r
        r2 = runner("preempt")
        resumed_at, restarts = r2.sim.chunk, r2.sim.lifecycle["restarts"]
        second = r2.run(RUNNER_CHUNKS - resumed_at)
        line["preempt_resume"] = {
            "first": first, "resumed_at": resumed_at, "restarts": restarts,
            "second": second, "equal_to_reference": same(r2.sim)}
        if (first, resumed_at, restarts, second) != \
                ("preempted", 4, 1, "done") or not same(r2.sim):
            fail(f"runner_path: preempt and resume {line['preempt_resume']}")
        del r2

        # a NaN after chunk 3: rolled back, run again
        r = runner("rollback")
        r.chaos_hooks.append(chaos.poison_nan_once(field="v", after_chunk=3))
        status = r.run(RUNNER_CHUNKS)
        line["rollback"] = {"status": status,
                            "lifecycle": dict(r.sim.lifecycle),
                            "equal_to_reference": same(r.sim)}
        if status != "done" or r.sim.lifecycle["rollbacks"] < 1 or \
                not same(r.sim):
            fail(f"runner_path: NaN rollback {line['rollback']}")
        del r

        # the newest checkpoint truncated: a fresh runner resumes older
        ck = os.path.join(CKPT_ROOT, "preempt")
        newest = chaos.corrupt_checkpoint(ck, mode="truncate")
        r3 = runner("preempt")
        line["corrupt_newest"] = {"corrupted": newest,
                                  "resumed_at": r3.sim.chunk}
        if not r3.sim.chunk < newest:
            fail(f"runner_path: resumed at {r3.sim.chunk} past the corrupt "
                 f"step {newest}")
        del r3

        # the costs at R=1, on the reference's state after the last chunk
        save_dir = os.path.join(CKPT_ROOT, "save_r1")
        copy_ms = [_timed(lambda: manager.host_copy(ref.state))[1]
                   for _ in range(3)]
        step, save_ms = _timed(lambda: ref.save(save_dir))
        fresh = Simulator.from_config(cfg, scenario=scenario, device=DEV)
        _, restore_ms = _timed(lambda: fresh.restore(save_dir))
        probe = [_timed(ref.probe_health) for _ in range(4)]
        line["costs_R1"] = {
            "checkpoint_mb": _ckpt_mb(os.path.join(save_dir,
                                                   f"step_{step}")),
            "inline_copy_ms": copy_ms, "save_ms": save_ms,
            "restore_ms": restore_ms,
            "probe_health_ms": [ms for _, ms in probe],
            "probe_flags": [f for f, _ in probe],
            "restored_equal": _all_leaves_equal(fresh.state, ref.state)}
        if not line["costs_R1"]["restored_equal"] or \
                any(f for f, _ in probe):
            fail(f"runner_path: restore or probe {line['costs_R1']}")
        del ref, fresh
        torch.cuda.empty_cache()

        # elastic R=4 -> R=2, dense (new and old) and sparse (as both)
        elastic_line = {}
        for ex in ("dense", "sparse"):
            c4 = dataclasses.replace(cmp_cfg, rate_exchange=ex)
            sim4 = Simulator.from_config(c4, scenario=cmp_scenario,
                                         num_ranks=4, device=DEV)
            sim4.run(2)
            d4 = os.path.join(CKPT_ROOT, f"r4_{ex}")
            step4, save4_ms = _timed(lambda: sim4.save(d4))
            written = {f: getattr(sim4.state, f) for f in (
                "out_edges", "in_edges", "positions")}
            del sim4
            runs = {}
            variants = (("new", {}), ("old", {"connectivity_alg": "old"})) \
                if ex == "dense" else (("sparse", {}), (
                    "dense", {"rate_exchange": "dense"}))
            for name, kw in variants:
                c2 = dataclasses.replace(c4, neurons_per_rank=2 * n, **kw)
                (sim2, step2), ms = _timed(lambda: elastic.remesh_restore_brain(
                    d4, c2, num_ranks=2, scenario=cmp_scenario, device=DEV))
                as_written = step2 == step4 and all(
                    torch.equal(getattr(sim2.state, f), x)
                    for f, x in written.items())
                sim2.step()
                st = sim2.state
                runs[name] = {
                    "restore_ms": ms, "as_written": as_written,
                    "health_flags": sim2.health()["health_flags"],
                    "synapses_formed": sim2.stats()["synapses_formed"],
                    "state": st}
            a, b = (runs[k]["state"] for k in runs)
            if ex == "dense":
                equal = (torch.equal(torch.sort(a.out_edges, 1)[0],
                                     torch.sort(b.out_edges, 1)[0])
                         and torch.equal(torch.sort(a.in_edges, 1)[0],
                                         torch.sort(b.in_edges, 1)[0])
                         and runs["new"]["synapses_formed"]
                         == runs["old"]["synapses_formed"] > 0)
            else:
                equal = _same_state(a, b)
            for v in runs.values():
                del v["state"]
            elastic_line[ex] = {"checkpoint_mb": _ckpt_mb(os.path.join(
                d4, f"step_{step4}")), "save_ms": save4_ms, "runs": runs,
                "old_equals_new" if ex == "dense" else "sparse_equals_dense":
                    equal}
            del a, b, runs
            torch.cuda.empty_cache()
            bad = [k for k, v in elastic_line[ex]["runs"].items()
                   if not v["as_written"] or v["health_flags"]]
            if not equal or bad:
                fail(f"runner_path: elastic R=4 -> R=2 {ex}: equal={equal},"
                     f" not as written or unhealthy: {bad}")
        line["elastic_R4_to_R2"] = elastic_line
    finally:
        shutil.rmtree(CKPT_ROOT, ignore_errors=True)
    emit(line)
    return line, counts


SERVICE_TENANTS = 6     # seeds 100-105, priority i % 2, as serve.py
SERVICE_CHUNKS = 3      # submits them
STEADY_CHUNKS = 25      # the timed window: four tenants, four lanes a tick


def _service_run(cfg, scenario, num_slots: int, tenants: int, chunks: int,
                 poison: bool, num_ranks: int = 1, timed: bool = False):
    """A ``SimulationService`` at ``cfg`` on the card with ``tenants``
    requests submitted as ``launch/serve.py`` submits them (seed 100 + i,
    priority i % 2), slot 1 NaN-poisoned after its first chunk when
    ``poison``, driven to idle: through ``run_until_idle``, or with
    ``timed`` tick by tick (the same loop), each tick's wall ms and lanes
    stepped recorded. Returns (service, handles, tick ms, lanes a tick,
    wall s from the first submit to idle)."""
    import torch
    from repro_torch.runtime import chaos
    from repro_torch.service import (ServiceConfig, SimRequest,
                                     SimulationService)
    svc = SimulationService(cfg, ServiceConfig(num_slots=num_slots,
                                               queue_cap=8),
                            scenario=scenario, num_ranks=num_ranks,
                            device=DEV)
    if poison:
        svc.chaos_hooks.append(chaos.poison_slot_nan(1, after_chunk=1))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    handles = [svc.submit(SimRequest(seed=100 + i, chunks=chunks,
                                     priority=i % 2, tag=f"tenant{i}"))
               for i in range(tenants)]
    ticks, lanes = [], []
    if timed:
        more = True
        while more:
            before = svc.batch.lane_chunks
            more, ms = _timed(svc.tick)
            ticks.append(ms)
            lanes.append(svc.batch.lane_chunks - before)
    else:
        svc.run_until_idle()
    torch.cuda.synchronize()
    return svc, handles, ticks, lanes, time.perf_counter() - t0


def _service_launch_faults(counts, admitted: int, lane_chunks: int,
                           num_ranks: int):
    """{kernel: (launched, wanted)} where the service's launches are not
    the admissions' and the lane-chunks' (every rank's): K0 three a rank
    and admission (``init_state``), and at R > 1 two a rank and lane-chunk
    (phase A's Gumbel draws); K1, K2, K3 and the tree assembly one a rank
    and lane-chunk, K4 three, K5 and the retraction two, ``edge_priority``
    none."""
    per = num_ranks * lane_chunks
    want = {"activity_window": per, "bh_traverse": per, "morton_sort": per,
            "tree_assembly": per, "synapse_apply": 3 * per,
            "route_build": 2 * per, "retract": 2 * per, "edge_priority": 0,
            "threefry_words": 3 * num_ranks * admitted
            + (2 * per if num_ranks > 1 else 0)}
    return {k: (counts.get(k, 0), v) for k, v in want.items()
            if counts.get(k, 0) != v}


def _serve_driver():
    """``python -m repro_torch.launch.serve --smoke`` in this process, on
    the card (its default device), the launch counts set to 0 before it
    and read after: exit code 0, its three tenants DONE, and the launches
    of three admissions and nine lane-chunks (two slots, three tenants of
    three chunks, nothing replayed), no plain version on a CUDA tensor."""
    import contextlib
    import io
    from repro_torch.launch import serve
    _reset_counts()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = serve.main(["--smoke"])
    counts, plain_leaf, plain_tf = _read_counts()
    lines = out.getvalue().splitlines()
    res = {"rc": rc, "tenant_lines": [x.strip() for x in lines
                                      if x.strip().startswith("tenant")],
           "last_line": lines[-1] if lines else None, "launches": counts,
           "launch_faults": _service_launch_faults(counts, 3, 9, 1),
           "plain_leaf_sums_on_cuda": plain_leaf,
           "plain_threefry_on_cuda": plain_tf}
    if rc != 0 or res["last_line"] != "3/3 tenants DONE" \
            or res["launch_faults"] or plain_leaf or plain_tf:
        fail(f"service_path serve driver: {res}")
    return res


def _profile_tick(svc, card):
    """One tick of ``svc`` under torch.profiler
    (build/chip_smoke_service_tick_trace.json): the device busy time
    (kernels, copies, memsets) against the tick's wall time, and the
    ranges with the device work launched inside them
    (``ranges_by_launch``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function("chip_smoke.service_tick"):
            t0 = time.perf_counter()
            svc.tick()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "build")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "chip_smoke_service_tick_trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    w = next(e for e in events if e.get("cat") == "user_annotation"
             and e["name"] == "chip_smoke.service_tick")
    lo, hi = w["ts"], w["ts"] + w["dur"]
    events = [e for e in events if "ts" in e and lo <= e["ts"] <= hi
              and e is not w]
    dev = [e for e in events
           if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    busy = sum(e["dur"] for e in dev) / 1e3
    ranges = ranges_by_launch(events, dev)
    return {"tick_wall_ms": wall, "device_busy_ms": busy,
            "device_idle_share": 1.0 - busy / wall if dev else None,
            "device_launches": len(dev),
            "ranges_by_launch": {k: v for k, v in ranges.items()
                                 if k.startswith(("repro.service",
                                                  "repro.activity",
                                                  "repro.connectivity",
                                                  "repro.health"))}}


def service_path(cfg, scenario, cmp_cfg, cmp_scenario, card):
    """The multi-tenant service at CONFIG on the card
    (``repro_torch.service``), all five lowerings fused in every lane:

    R=1 under ``scenario``: six tenants (seeds 100-105, 3 chunks each,
    priority i % 2, as ``launch/serve.py`` submits them) on four slots,
    queue cap 8. Solo references first, ``Simulator.from_config(replace(cfg,
    seed=s), scenario=...)`` a chunk at a time (timed); an unpoisoned run
    tick by tick (its wall time gives requests a second); then the same with slot 1
    NaN-poisoned after its first chunk, through ``run_until_idle``, the
    launch counts set to 0 before it and read after: all DONE, a quarantine
    and a rollback, every final state bitwise its solo run, the co-tenants'
    observations bitwise the unpoisoned run's, every kernel's launches
    those of the admissions and lane-chunks (``_service_launch_faults``),
    the health flags and a probe 0 on every lane. The readouts' ms
    (``probe``, ``observe``, ``health_flags``, a lane's snapshot) on the
    final lanes. The serve driver's smoke run (``_serve_driver``).

    The timed window: four tenants of ``STEADY_CHUNKS`` chunks on four
    slots, so that every tick steps four lanes; the first tick (the
    admissions and the lanes' first chunk) is left out. Its p50 and max
    tick ms, and ``isolation_overhead_x`` as
    ``benchmarks/bench_service.py`` defines it: the p50 tick over the
    tenants over a solo chunk, here the median of seed 100's chunks 2 to
    ``STEADY_CHUNKS`` after an untimed first chunk (the chunks the window's
    ticks run). Then one profiled tick of four lanes.

    R=4, the comparison cell (``cmp_cfg``, ``cmp_scenario``) dense and
    sparse: two slots, two tenants of 2 chunks, slot 1 poisoned; each
    tenant bitwise its solo R=4 run. Returns (the JSON line, the R=1
    poisoned run's launch counts with its K0 draws by mode under
    ``modes``, the R=4 runs' launch counts)."""
    import numpy as np
    import statistics
    import torch
    from repro_torch.kernels import hash as chash
    from repro_torch.service import RequestStatus
    from repro_torch.sim.api import Simulator
    line = {"phase": "service_path", "card": card,
            "config": "CONFIG, all five lowerings fused in every lane, "
                      "lesion_rewiring", "neurons_per_rank":
                cfg.neurons_per_rank, "slots": 4, "queue_cap": 8,
            "tenants": SERVICE_TENANTS, "chunks_per_tenant": SERVICE_CHUNKS}
    seeds = [100 + i for i in range(SERVICE_TENANTS)]

    # the solo references
    solo = {}
    for s in seeds:
        sim = Simulator.from_config(dataclasses.replace(cfg, seed=s),
                                    scenario=scenario, device=DEV)
        sim.run(SERVICE_CHUNKS)
        solo[s] = sim.state
        del sim

    # an unpoisoned run, tick by tick
    _, clean, clean_ms, clean_lanes, wall = _service_run(
        cfg, scenario, 4, SERVICE_TENANTS, SERVICE_CHUNKS, poison=False,
        timed=True)

    # slot 1 poisoned, through run_until_idle, its launches counted
    _reset_counts()
    chash.mode_launches(reset=True)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    svc, hs, _, _, poisoned_s = _service_run(
        cfg, scenario, 4, SERVICE_TENANTS, SERVICE_CHUNKS, poison=True)
    counts, plain_leaf, plain_tf = _read_counts()
    modes = chash.mode_launches(reset=True)
    peak_gb = (torch.cuda.max_memory_allocated() - held) / 1e9
    stats = svc.stats()
    admitted, lane_chunks = stats["requests_admitted"], svc.batch.lane_chunks
    statuses = [h.result.status.value for h in hs]
    bitwise = [h.result.status is RequestStatus.DONE
               and _all_leaves_equal(h.result.final_state,
                                     solo[h.request.seed]) for h in hs]
    cotenants = [np.array_equal(h.result.observations,
                                clean[i].result.observations)
                 for i, h in enumerate(hs) if i != 1]
    launch_faults = _service_launch_faults(counts, admitted, lane_chunks, 1)
    flags = svc.batch.health_flags(svc.state).tolist()
    probed = svc.batch.probe(svc.state).tolist()

    # the readouts on the four final lanes
    def ms3(fn):
        return [_timed(fn)[1] for _ in range(3)]

    readouts = {"probe_ms": ms3(lambda: svc.batch.probe(svc.state)),
                "observe_ms": ms3(lambda: svc.batch.observe(svc.state)),
                "health_flags_ms": ms3(
                    lambda: svc.batch.health_flags(svc.state)),
                "snapshot_ms": ms3(lambda: svc.batch.extract(svc.state, 0)),
                "lanes": sum(x is not None for x in svc.state)}
    del svc, solo
    torch.cuda.empty_cache()
    line["serve_driver"] = _serve_driver()
    torch.cuda.empty_cache()

    line["R1"] = {
        "statuses": statuses, "stats": stats, "lane_chunks": lane_chunks,
        "retries": [h.result.retries for h in hs],
        "bitwise_solo": bitwise, "cotenant_observations_equal": cotenants,
        "health_flags": flags, "probe_flags": probed, "launches": counts,
        "draw_launches_by_mode": modes,
        "launch_faults": launch_faults, "plain_leaf_sums_on_cuda":
            plain_leaf, "plain_threefry_on_cuda": plain_tf,
        "poisoned_run_s": poisoned_s}
    if any(st != "done" for st in statuses) or stats["quarantines"] < 1 \
            or stats["slot_rollbacks"] < 1 or not all(bitwise) \
            or not all(cotenants) or launch_faults or any(flags) \
            or any(probed) or plain_leaf or plain_tf:
        fail(f"service_path R=1: {line['R1']}")

    # R=4, dense and sparse: two tenants, slot 1 poisoned
    r4 = {}
    for ex in ("dense", "sparse"):
        c4 = dataclasses.replace(cmp_cfg, rate_exchange=ex)
        ref = {}
        for s in (100, 101):
            sim = Simulator.from_config(dataclasses.replace(c4, seed=s),
                                        scenario=cmp_scenario, num_ranks=4,
                                        device=DEV)
            sim.run(2)
            ref[s] = sim.state
            del sim
        _reset_counts()
        svc4, h4, _, _, sec = _service_run(c4, cmp_scenario, 2, 2, 2,
                                           poison=True, num_ranks=4)
        c4_counts, _, _ = _read_counts()
        st4 = svc4.stats()
        r4[ex] = {
            "statuses": [h.result.status.value for h in h4],
            "quarantines": st4["quarantines"],
            "slot_rollbacks": st4["slot_rollbacks"],
            "lane_chunks": svc4.batch.lane_chunks, "seconds": sec,
            "bitwise_solo": [h.result.status is RequestStatus.DONE
                             and _all_leaves_equal(h.result.final_state,
                                                   ref[h.request.seed])
                             for h in h4],
            "launches": c4_counts, "launch_faults": _service_launch_faults(
                c4_counts, st4["requests_admitted"],
                svc4.batch.lane_chunks, 4)}
        del svc4, h4, ref
        torch.cuda.empty_cache()
        if not all(r4[ex]["bitwise_solo"]) or r4[ex]["quarantines"] < 1 \
                or r4[ex]["launch_faults"]:
            fail(f"service_path R=4 {ex}: {r4[ex]}")
    line["R4"] = r4

    # the timed window: every tick steps four lanes, the first left out
    sim = Simulator.from_config(dataclasses.replace(cfg, seed=100),
                                scenario=scenario, device=DEV)
    sim.run(1)
    solo_ms = [_timed(lambda: sim.run(1))[1]
               for _ in range(STEADY_CHUNKS - 1)]
    solo_median = statistics.median(solo_ms)
    del sim
    steady_svc, _, tick_ms, lanes, _ = _service_run(
        cfg, scenario, 4, 4, STEADY_CHUNKS, poison=False, timed=True)
    if lanes[:STEADY_CHUNKS] != [4] * STEADY_CHUNKS \
            or steady_svc.stats()["quarantines"]:
        fail(f"service_path: the timed window stepped {lanes} lanes a "
             f"tick, {steady_svc.stats()}")
    tick_ms = tick_ms[1:STEADY_CHUNKS]
    del steady_svc
    torch.cuda.empty_cache()

    # one tick of four lanes profiled (after an unprofiled first tick)
    from repro_torch.service import (ServiceConfig, SimRequest,
                                     SimulationService)
    prof_svc = SimulationService(cfg, ServiceConfig(num_slots=4),
                                 scenario=scenario, device=DEV)
    for i in range(4):
        prof_svc.submit(SimRequest(seed=100 + i, chunks=2))
    prof_svc.tick()
    profiled = _profile_tick(prof_svc, card)
    del prof_svc
    torch.cuda.empty_cache()

    p50 = float(np.percentile(tick_ms, 50))
    emit({"phase": "service_metrics", "card": card,
          "window": f"4 tenants x {STEADY_CHUNKS} chunks on 4 slots, 4 "
                    f"lanes every tick, the first tick left out",
          "tick_ms": tick_ms, "tick_ms_p50": p50,
          "tick_ms_max": max(tick_ms),
          "tick_ms_p99": float(np.percentile(tick_ms, 99))
          if len(tick_ms) >= 100 else None,
          "tick_ms_p99_note": f"{len(tick_ms)} ticks: a p99 needs 100; "
                              f"tick_ms_max given",
          "solo_chunk_ms": solo_ms, "solo_chunk_ms_median": solo_median,
          "isolation_overhead_x": p50 / 4 / solo_median,
          "isolation_overhead_note": "p50 tick / 4 tenants / the solo "
                                     "chunk's median (bench_service.py)",
          "requests_per_s": SERVICE_TENANTS / wall,
          "requests_per_s_run": f"{SERVICE_TENANTS} tenants x "
                                f"{SERVICE_CHUNKS} chunks on 4 slots, first "
                                f"submit to idle, admissions included",
          "clean_run_tick_ms": clean_ms,
          "clean_run_lanes_per_tick": clean_lanes,
          "profiled_tick": profiled, **readouts, "peak_mem_gb": peak_gb})
    emit(line)
    return line, dict(counts, modes=modes), {ex: r4[ex]["launches"]
                                             for ex in r4}



# ------------------------------------------------------------ the LM path
# (arch, batch, prompt tokens, greedy decode steps): the full configs
# (configs/qwen2_7b.py: 28 layers, d_model 3,584, 7.62e9 parameters;
# configs/recurrentgemma_2b.py: 26 layers, 8 of them local attention with a
# window of 2,048, which the prompt passes), bf16, weights from seed 0, the
# prompt from seed 1; no cut
LM_CELLS = (("qwen2-7b", 8, 1024, 32), ("recurrentgemma-2b", 4, 2560, 32))
LM_TIMEOUT_S = 420


def _lm_f32(tree):
    if isinstance(tree, dict):
        return {k: _lm_f32(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_lm_f32(v) for v in tree]
    return tree.float()


def _lm_leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _lm_leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _lm_leaves(v)
    else:
        yield tree


def lm_work(cfg, params, batch: int, prompt: int, steps: int):
    """The least time of the prefill and of the median decode step, from the
    config and the params: each weight read once (the embedding table's B
    rows only), the KV cache written once by the prefill and the valid
    entries read once a step; bf16 multiply-adds (2 operations) at the
    tensor cores' bf16 rate and the RG-LRU gates' float32 ones at the FP32
    rate, attention at 4 D operations a (query, key) pair; and the least
    memory a server holds, the params and one decode state. Returns
    {"prefill": (ms, by, bytes, bf16 ops, f32 ops), "decode": (...),
    "memory_gb": GB}."""
    import torch
    emb = params["embed"]["table"]
    wbytes = sum(t.numel() * t.element_size() for t in _lm_leaves(params))
    pbytes = wbytes
    wbytes += batch * cfg.d_model * emb.element_size() - emb.numel() * \
        emb.element_size()
    layer_leaves = list(_lm_leaves(params.get("layers_stacked")
                                   or params["layers"]))
    macs = {torch.bfloat16: 0, torch.float32: 0}
    for t in layer_leaves:
        if t.dim() >= 2:        # a matmul weight (or the conv's taps)
            macs[t.dtype] += t.numel()
    head = cfg.d_model * cfg.vocab_size
    kinds = cfg.pattern()
    n_attn = sum(k == "attn" for k in kinds)
    kv_pos = 2 * batch * cfg.num_kv_heads * cfg.head_dim * emb.element_size()
    window = cfg.attn_window
    tokens = batch * prompt

    def one(nbytes, bf16_ops, f32_ops):
        ms = {"bytes": nbytes / H100_BYTES_PER_S * 1e3,
              "operations": max(bf16_ops / H100_BF16_OPS_PER_S,
                                f32_ops / H100_FP32_OPS_PER_S) * 1e3}
        by = max(ms, key=ms.get)
        return ms[by], by, nbytes, bf16_ops, f32_ops

    slots = min(prompt, window) if window else prompt
    attn_pre = 4 * cfg.head_dim * cfg.num_heads * batch * \
        attention_pairs(prompt, prompt, window) * n_attn
    pre = one(wbytes + n_attn * kv_pos * slots,
              2 * tokens * macs[torch.bfloat16] + 2 * batch * head
              + attn_pre, 2 * tokens * macs[torch.float32])
    pos = prompt + steps // 2
    seen = min(pos + 1, window) if window else pos + 1
    dec = one(wbytes + n_attn * kv_pos * (seen + 1),
              2 * batch * (macs[torch.bfloat16] + head)
              + 4 * cfg.head_dim * cfg.num_heads * batch * seen * n_attn,
              2 * batch * macs[torch.float32])
    rec = sum(k == "rglru" for k in kinds) * batch * cfg.d_model * 4 * \
        cfg.rglru_conv_width          # h and the conv tail, f32
    state = n_attn * kv_pos * (window or prompt + steps) + rec
    return {"prefill": pre, "decode": dec, "memory_gb": (pbytes + state) / 1e9}


def _lm_profile(fn, name: str):
    """One call of ``fn`` under torch.profiler
    (build/chip_smoke_<name>_trace.json): its wall ms, the device's busy ms
    (kernels, copies, memsets), idle share and launches, the kernels that
    take the most device time."""
    import collections
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(f"chip_smoke.{name}"):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "build")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"chip_smoke_{name}_trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    w = next(e for e in events if e.get("cat") == "user_annotation"
             and e["name"] == f"chip_smoke.{name}")
    lo, hi = w["ts"], w["ts"] + w["dur"]
    dev = [e for e in events if "ts" in e and lo <= e["ts"] <= hi
           and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    busy = sum(e["dur"] for e in dev) / 1e3
    by_name = collections.defaultdict(lambda: [0.0, 0])
    for e in dev:
        by_name[e["name"][:80]][0] += e["dur"] / 1e3
        by_name[e["name"][:80]][1] += 1
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    return {"wall_ms": wall, "device_busy_ms": busy,
            "device_idle_share": 1.0 - busy / wall if dev else None,
            "device_launches": len(dev),
            "top_device": [{"name": k, "ms": v[0], "launches": v[1]}
                           for k, v in top]}


def _lm_first_attention(api, params, cfg, batch):
    """q (pre-scaled as the model scales it), k and v of the first
    attention layer of the prefill of ``batch``."""
    import torch
    from repro_torch.models import attention as attn
    from repro_torch.models import transformer as tfm
    from repro_torch.models.layers import apply_norm
    x = tfm.embed_inputs(params, cfg, batch["tokens"])
    pos = torch.arange(x.shape[1], device=x.device)
    for i, kind in enumerate(cfg.pattern()):
        p = tfm.layer_params(params, i)
        if kind == "attn":
            q, k, v = tfm._project_qkv(p["attn"], cfg,
                                       apply_norm(cfg, p["ln1"], x), pos)
            return attn.prescale(q), k.contiguous(), v.contiguous()
        x, _ = tfm.apply_layer_full(p, cfg, kind, x, pos)
    raise ValueError("no attention layer")


def _greedy_agreement(got, want, want_logits, tol):
    """Row by row, the first step where the greedy tokens differ must be a
    near-tie of the reference's logits (top-2 gap under ``tol``); that ends
    the row's comparison. Returns (near-ties, decisions compared, rows'
    compared steps) or raises through ``fail``."""
    import torch
    ties = compared = 0
    upto = []
    for b in range(want.shape[0]):
        n = want.shape[1]
        for t in range(want.shape[1]):
            compared += 1
            if int(got[b, t]) == int(want[b, t]):
                continue
            top2 = torch.topk(want_logits[t][b].float(), 2).values
            gap = float(top2[0] - top2[1])
            if gap >= tol:
                fail(f"lm_serve_path: row {b} step {t}: greedy token "
                     f"{int(got[b, t])} against {int(want[b, t])}, a top-2 "
                     f"gap of {gap} (tolerance {tol})")
            ties += 1
            n = t
            break
        upto.append(n)
    return ties, compared, upto


def lm_cell(arch: str, batch: int, prompt: int, steps: int, card: str):
    """One LM cell on the card: ``build_model(get_config(arch))``, greedy
    prefill + ``steps`` decode steps (the attention lowering fused: K9 on
    every attention layer's prefill). Checks, failing otherwise: K9's device
    launches (counted in the .cu source) one a prefill attention layer and
    none a decode step; the fused model against the same params on the
    reference attention lowering (the plain chunked online softmax),
    logits within the tolerance below and greedy tokens equal but for
    counted near-ties; the first attention layer's K9 output within
    ``flash_attention.bf16_error_bound`` (scale 1.0 on the pre-scaled q);
    prefill + decode against ``transformer.forward`` at the same
    positions; a second run bitwise equal; one decode step under
    ``torch.cuda.set_sync_debug_mode("error")``. The logits tolerance: both
    lowerings are bf16 evaluations of one model, so the reference's own
    error against its float32 evaluation (the params cast to f32, the plain
    attention in f32) sets the scale: tol = 2 max |ref - f32| over the
    prefill's logits. Reports init s, prefill ms (CUDA events), decode ms a
    step (median and spread of steps 2-32), tokens a second, peak GB and a
    profiled decode step, each beside its bound (``lm_work``)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import serve_lm
    from repro_torch.models import build_model
    from repro_torch.models import transformer as tfm
    from repro_torch.models.layers import lm_logits
    cfg = get_config(arch)
    n_attn = sum(k == "attn" for k in cfg.pattern())
    api = build_model(cfg)
    pad = prompt + steps + 2        # room for the sync-debug and profiled steps
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = api.init(0, device=DEV)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    batch_in = serve_lm.make_batch(cfg, batch, prompt, DEV, seed=1)
    res = {"arch": arch, "batch": batch, "prompt": prompt,
           "decode_steps": steps, "pad_cache_to": pad,
           "layers": cfg.num_layers, "attention_layers": n_attn,
           "d_model": cfg.d_model, "heads": [cfg.num_heads,
                                             cfg.num_kv_heads],
           "head_dim": cfg.head_dim, "window": cfg.attn_window,
           "vocab": cfg.vocab_size, "params": cfg.param_count(),
           "cut": None, "init_s": init_s}

    def drive(count: bool, timed: bool):
        """api.prefill + ``steps`` decode steps: tokens, logits, and (when
        ``count``) K9's launches after the prefill and over the steps, or
        (when ``timed``) the prefill's and each step's CUDA-event ms."""
        ev = [torch.cuda.Event(enable_timing=True)
              for _ in range(2 * steps + 2)] if timed else None
        if count:
            _build.reset_launch_counts()
            fa.device_launches(reset=True)
        if timed:
            torch.cuda.synchronize()
            ev[0].record()
        logits, state = api.prefill(params, batch_in, pad_cache_to=pad)
        tok = torch.argmax(logits, -1).to(torch.int32)
        if timed:
            ev[1].record()
        if count:
            pre = (_build.launch_counts()["flash_attention"],
                   fa.device_launches(reset=True))
        toks, all_logits = [tok], [logits]
        for i in range(steps):
            if timed:
                ev[2 + 2 * i].record()
            logits, state = api.decode_step(params, state, tok)
            tok = torch.argmax(logits, -1).to(torch.int32)
            if timed:
                ev[3 + 2 * i].record()
            toks.append(tok)
            all_logits.append(logits)
        out = {"tokens": torch.stack(toks, 1), "logits": all_logits}
        if count:
            out["launches"] = {
                "prefill": pre[0], "prefill_device": pre[1],
                "decode": _build.launch_counts()["flash_attention"] - pre[0],
                "decode_device": fa.device_launches(reset=True)}
        if timed:
            torch.cuda.synchronize()
            out["prefill_ms"] = ev[0].elapsed_time(ev[1])
            out["step_ms"] = [ev[2 + 2 * i].elapsed_time(ev[3 + 2 * i])
                              for i in range(steps)]
        return out

    first = drive(count=True, timed=False)
    want_k9 = {name: (n_attn if name == "wgmma_bf16" else 0)
               for name in fa.KERNELS}
    got = first["launches"]
    res["k9_launches"] = got
    if got["prefill"] != n_attn or got["prefill_device"] != want_k9 or \
            got["decode"] != 0 or any(got["decode_device"].values()):
        fail(f"lm_serve_path {arch}: K9 launches {got}, not {n_attn} "
             f"wgmma_bf16 a prefill and none a decode step")
    second = drive(count=False, timed=True)
    same = torch.equal(first["tokens"], second["tokens"]) and all(
        torch.equal(a, b) for a, b in zip(first["logits"], second["logits"]))
    res["second_run_bitwise_equal"] = same
    if not same:
        fail(f"lm_serve_path {arch}: a second run differs")
    # the serving peak: params, two runs' caches and logits, activations
    res["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    steps_ms = sorted(second["step_ms"][1:])
    med = steps_ms[len(steps_ms) // 2]
    res.update({"prefill_ms": second["prefill_ms"],
                "decode_step_ms": {"median": med, "min": steps_ms[0],
                                   "max": steps_ms[-1],
                                   "steps": "2-%d" % steps},
                "tokens_per_s": batch * 1e3 / med})
    work = lm_work(cfg, params, batch, prompt, steps)
    for key in ("prefill", "decode"):
        ms, by, nbytes, bf, f32 = work[key]
        res[f"{key}_bound"] = {"ms": ms, "by": by, "bytes": nbytes,
                               "bf16_ops": bf, "f32_ops": f32}
    res["tokens_per_s_bound"] = batch * 1e3 / work["decode"][0]
    res["peak_gb_bound"] = work["memory_gb"]
    del second

    # the reference attention lowering, the same params and prompt
    ref_api = build_model(cfg.replace(attention_impl="reference"))
    _build.reset_launch_counts()
    ref_toks, ref_logits = serve_lm.generate(ref_api, params, batch_in,
                                             steps + 1, pad)
    if _build.launch_counts()["flash_attention"]:
        fail(f"lm_serve_path {arch}: the reference lowering launched K9")
    # the tolerance: the reference's error against its f32 evaluation
    p32 = _lm_f32(params)
    f32_api = build_model(cfg.replace(dtype="float32",
                                      attention_impl="reference"))
    l32, _ = f32_api.prefill(p32, batch_in, pad_cache_to=pad)
    del p32
    torch.cuda.empty_cache()
    ref_err = float((ref_logits[0].float() - l32).abs().max())
    tol = 2.0 * ref_err
    res["tolerance"] = {"logits": tol, "ref_vs_f32_max_abs": ref_err,
                        "fused_vs_f32_max_abs": float(
                            (first["logits"][0].float() - l32).abs().max()),
                        "logits_max_abs": float(l32.abs().max()),
                        "rule": "2 max|ref - f32| over the prefill logits"}
    del l32
    pre_err = float((first["logits"][0].float()
                     - ref_logits[0].float()).abs().max())
    ties, compared, upto = _greedy_agreement(first["tokens"], ref_toks,
                                             ref_logits, tol)
    dec_err = 0.0
    for b, n in enumerate(upto):       # logits while the contexts agree
        for t in range(1, min(n, steps) + 1):
            dec_err = max(dec_err, float(
                (first["logits"][t][b].float()
                 - ref_logits[t][b].float()).abs().max()))
    res["fused_vs_reference"] = {
        "prefill_logits_max_abs": pre_err, "decode_logits_max_abs": dec_err,
        "greedy_decisions_compared": compared, "near_ties": ties,
        "rows_compared_steps": upto}
    if pre_err > tol or dec_err > tol:
        fail(f"lm_serve_path {arch}: fused against reference logits "
             f"{pre_err} (prefill), {dec_err} (decode) > {tol}")
    del ref_logits, ref_toks

    # prefill + decode against the full forward at the same positions
    seq = torch.cat([batch_in["tokens"], first["tokens"][:, :steps]], 1)
    hidden, _ = tfm.forward(params, cfg, seq, return_hidden=True)
    fwd = lm_logits(params["head"], params["embed"], cfg,
                    hidden[:, prompt - 1:])
    del hidden
    fwd_err = max(float((first["logits"][t].float()
                         - fwd[:, t].float()).abs().max())
                  for t in range(steps + 1))
    res["serve_vs_forward_max_abs"] = fwd_err
    if fwd_err > tol:
        fail(f"lm_serve_path {arch}: prefill + decode against forward "
             f"{fwd_err} > {tol}")
    del fwd, first
    torch.cuda.empty_cache()

    # K9 at this model's first attention layer: within the bf16 bound of
    # its plain version on the same (pre-scaled) q, scale 1.0; times
    q, k, v = _lm_first_attention(api, params, cfg, batch_in)
    w = cfg.attn_window
    kern = fa.flash_attention_fwd(q, k, v, causal=True, window=w, scale=1.0)
    plain = fa.flash_attention_plain(q, k, v, causal=True, window=w,
                                     scale=1.0)
    lim = fa.bf16_error_bound(plain, q, k, v, causal=True, window=w,
                              scale=1.0)
    diff = (kern.float() - plain.float()).abs()
    k9 = {"shape": {"B": batch, "Hq": cfg.num_heads, "Hkv": cfg.num_kv_heads,
                    "S": q.shape[2], "D": cfg.head_dim, "window": w},
          "max_abs_err": float(diff.max()),
          "max_err_over_bound": float((diff / lim).max())}
    del plain, lim, diff
    if k9["max_err_over_bound"] > 1.0:
        fail(f"lm_serve_path {arch}: K9 at the first attention layer "
             f"{k9['max_err_over_bound']} times its bf16 bound")
    call = lambda: fa.flash_attention_fwd(   # noqa: E731
        q, k, v, causal=True, window=w, scale=1.0)
    k9["ms"] = cuda_ms(call, reps=10)
    k9["device_ms"] = device_ms(call, 10)
    k9["plain_ms"] = cuda_ms(lambda: fa.flash_attention_plain(
        q, k, v, causal=True, window=w, scale=1.0), reps=1)
    import torch.nn.functional as F
    if w and w < q.shape[2]:
        pos = torch.arange(q.shape[2], device=DEV)
        mask = (pos[None, :] <= pos[:, None]) & \
            (pos[:, None] - pos[None, :] < w)
        lib = lambda: F.scaled_dot_product_attention(   # noqa: E731
            q, k, v, attn_mask=mask, enable_gqa=True, scale=1.0)
    else:
        lib = lambda: F.scaled_dot_product_attention(   # noqa: E731
            q, k, v, is_causal=True, enable_gqa=True, scale=1.0)
    k9["library_ms"] = cuda_ms(lib, reps=10)
    pairs = batch * cfg.num_heads * attention_pairs(q.shape[2], k.shape[2], w)
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
    k9["bound_ms"], k9["bound_by"] = bound(
        nbytes, fp_ops=4 * cfg.head_dim * pairs,
        fp_ops_per_s=H100_BF16_OPS_PER_S)
    k9["launches"] = got["prefill"]
    res["k9"] = k9
    del q, k, v, kern
    torch.cuda.empty_cache()

    # one decode step with no host wait, then one profiled (after a warm
    # step): a profiler session slows the host for the rest of the process,
    # so it comes last
    logits, state = api.prefill(params, batch_in, pad_cache_to=pad)
    tok = torch.argmax(logits, -1).to(torch.int32)
    logits, state = api.decode_step(params, state, tok)
    tok = torch.argmax(logits, -1).to(torch.int32)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        logits, state = api.decode_step(params, state, tok)
        tok = torch.argmax(logits, -1).to(torch.int32)
    except RuntimeError as e:
        fail(f"lm_serve_path {arch}: a decode step waits for the host: {e}")
    finally:
        torch.cuda.set_sync_debug_mode(0)
    res["decode_step_without_host_wait"] = True
    res["peak_gb_with_checks"] = torch.cuda.max_memory_allocated() / 1e9
    res["profiled_decode_step"] = _lm_profile(
        lambda: api.decode_step(params, state, tok),
        f"lm_{arch.replace('-', '_')}_decode")
    res["profiled_decode_step"]["bound_ms"] = work["decode"][0]
    res["card"] = card
    return res


def lm_serve_path(card: str):
    """Each LM cell in a process of its own (``python3 chip_smoke.py
    lm_serve_path <arch>``), so that neither its memory nor its profiler
    session reaches the brain phases' timings. Emits the phase line and
    returns it."""
    cells = []
    for arch, _, _, _ in LM_CELLS:
        out = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "lm_serve_path",
             arch], capture_output=True, text=True, timeout=LM_TIMEOUT_S,
            env=dict(os.environ))
        if out.returncode != 0:
            fail(f"lm_serve_path {arch}: exit {out.returncode}\n"
                 f"{out.stdout[-3000:]}\n{out.stderr[-6000:]}")
        cells.append(json.loads(out.stdout.strip().splitlines()[-1]))
    line = {"phase": "lm_serve_path", "card": card, "cells": cells}
    emit(line)
    return line


def lm_child(arch: str) -> int:
    """The child of ``lm_serve_path``: one cell, its result as the last
    line."""
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell = next(c for c in LM_CELLS if c[0] == arch)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    emit(lm_cell(*cell, card=smi))
    return 0


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
    k0, k0_lines = check_k0(all_fused)
    kr_res, kr_err = check_retract(all_fused)
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
    # the multi-rank path's shapes: rank 3 of 4 (gid_base 3n, two branch
    # cells, R x cap query and message slots, four routing buckets)
    r4 = {"K2": k2_compare_and_time(
              slice_cfg, k2_inputs_ranks(slice_cfg, 4, 3),
              "K2 bh_traverse (R=4, rank 3)"),
          "K3": check_k3(all_fused, 4, 3), "K4": check_k4(all_fused, 4),
          "K5": check_k5(all_fused, 4, 3)}
    # the comparison paths' shapes: K0's counter-hash draws, K1's sparse
    # operand at rank 1 of 4, K2 on the old algorithm's global tree at rank
    # 3, K4's accept of the old algorithm's R x cap requests at the
    # comparison cell's cap (n)
    cmp_cfg = dataclasses.replace(all_fused, requests_cap_factor=4)
    hash_lines = check_hash_draws(all_fused)
    k1sp = k1_sparse_check(all_fused)
    k2g = k2_compare_and_time(slice_cfg, k2_inputs_global(slice_cfg),
                              "K2 bh_traverse (global tree, R=4, rank 3)")
    k4old = check_k4(cmp_cfg, 4)
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
          "K3_bound_ms": k3[2][0], "K3_device_launches_per_call": k3[5],
          "K4_drain_ms": k4["drain"][0],
          "K4_drain_device_ms": k4["drain"][4],
          "K4_drain_plain_ms": k4["drain"][1],
          "K4_drain_bound_ms": k4["drain"][2][0],
          "K4_device_launches_per_call": k4["drain"][5],
          "K4_accept_ms": k4["accept"][0],
          "K4_accept_device_ms": k4["accept"][4],
          "K4_accept_plain_ms": k4["accept"][1],
          "K4_accept_bound_ms": k4["accept"][2][0],
          "K4_accept_mode": "keyed (priorities drawn in K4)",
          "K4_accept_fed_ms": k4["accept"][6]["fed_ms"],
          "K4_accept_fed_device_ms": k4["accept"][6]["fed_device_ms"],
          "K5_ms": k5[0], "K5_device_ms": k5[4], "K5_plain_ms": k5[1],
          "K5_bound_ms": k5[2][0], "K5_device_launches_per_call": k5[5],
          "K5_caller_inputs_device_ms": k5[6],
          "K2_bound_ms": k2_bound,
          "retract_ms": kr_res["full"][0],
          "retract_device_ms": kr_res["full"][1],
          "retract_plain_ms": kr_res["full"][2],
          "retract_bound_ms": kr_res["full"][3][0],
          "retract_sparse_ms": kr_res["scenario_sparse"][0],
          "retract_sparse_device_ms": kr_res["scenario_sparse"][1],
          "retract_sparse_plain_ms": kr_res["scenario_sparse"][2],
          "retract_sparse_bound_ms": kr_res["scenario_sparse"][3][0],
          "edge_priority_ms": kr_res["priority"][0],
          "edge_priority_device_ms": kr_res["priority"][1],
          "edge_priority_plain_ms": kr_res["priority"][2],
          "edge_priority_bound_ms": kr_res["priority"][3][0],
          "K0_ms": k0["ms"], "K0_device_ms": k0["device_ms"],
          "K0_plain_ms": k0["plain_ms"], "K0_bound_ms": k0["bound"][0],
          "R4": {"K2_ms": r4["K2"][0], "K2_device_ms": r4["K2"][1],
                 "K2_plain_ms": r4["K2"][2], "K2_bound_ms": r4["K2"][3][0],
                 "K3_ms": r4["K3"][0], "K3_device_ms": r4["K3"][4],
                 "K3_plain_ms": r4["K3"][1], "K3_bound_ms": r4["K3"][2][0],
                 "K4_drain_ms": r4["K4"]["drain"][0],
                 "K4_drain_device_ms": r4["K4"]["drain"][4],
                 "K4_drain_plain_ms": r4["K4"]["drain"][1],
                 "K4_drain_bound_ms": r4["K4"]["drain"][2][0],
                 "K4_accept_ms": r4["K4"]["accept"][0],
                 "K4_accept_device_ms": r4["K4"]["accept"][4],
                 "K4_accept_plain_ms": r4["K4"]["accept"][1],
                 "K4_accept_bound_ms": r4["K4"]["accept"][2][0],
                 "K4_accept_fed_device_ms":
                     r4["K4"]["accept"][6]["fed_device_ms"],
                 "K5_ms": r4["K5"][0], "K5_device_ms": r4["K5"][4],
                 "K5_plain_ms": r4["K5"][1], "K5_bound_ms": r4["K5"][2][0]}})

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

    # ---- the LM serving path: qwen2-7b and recurrentgemma-2b at full
    # width, K9 on every prefill attention layer (a process a cell) -------
    lm = lm_serve_path(card)

    # ---- fused == reference on the card, small size --------------------
    exact_kernels = k1["exact"] and k1s["exact"] and k2_err == 0
    fused_vs_reference(SMOKE_CONFIG, None, 3, exact_kernels)
    for name in ("lesion_rewiring", "focal_stimulation"):
        fused_vs_reference(library.SMOKE_SCENARIO_CONFIG,
                           scaled(library.get_scenario(name), 5), 4,
                           exact_kernels)
    # and at four ranks in one process (dist.LocalComm), through the lesion
    fused_vs_reference(library.SMOKE_SCENARIO_CONFIG,
                       scaled(library.lesion_rewiring(), 5), 4,
                       exact_kernels, num_ranks=4)

    # ---- path 1: activity + traversal kernels, no scenario --------------
    from repro_torch.kernels import hash as chash
    _build.reset_launch_counts()
    chash.device_launches(reset=True)
    chash.plain_cuda_calls(reset=True)
    sim_main, _, warm, per_chunk, flags = run_main_path(slice_cfg, 2)
    main_counts = _build.launch_counts()
    k0_device = chash.device_launches(reset=True)
    if chash.plain_cuda_calls(reset=True):
        fail("the plain int64 Threefry ran on CUDA tensors on the main path")
    chunks = len(per_chunk) + 1
    keys = check_path("main_path", sim_main, slice_cfg, warm, per_chunk,
                      flags, main_counts,
                      device_counts={"threefry_words": k0_device})
    if main_counts["activity_window"] != chunks:
        fail(f"K1 launched {main_counts['activity_window']} times, not once "
             f"a window")
    if main_counts["bh_traverse"] < chunks:
        fail(f"K2 launched {main_counts['bh_traverse']} times")
    # K0: init_state's three draws, then the reference lowering's
    # priorities, three launches for each of the two retracted tables and
    # the request buffer a chunk
    k0_want = 3 + 9 * chunks
    if main_counts["threefry_words"] != k0_want or k0_device != k0_want:
        fail(f"K0 launched {main_counts['threefry_words']} times (the "
             f"source counted {k0_device}) on the main path, not {k0_want}")
    sim2, _, _, _, _ = run_main_path(slice_cfg, 2)
    same = (torch.equal(sim_main.state.in_edges, sim2.state.in_edges)
            and torch.equal(sim_main.state.out_edges, sim2.state.out_edges)
            and all(sim2.stats()[k] == sim_main.stats()[k] for k in keys))
    emit({"phase": "determinism", "path": "main_path", "equal": same})
    if not same:
        fail("a second run of the main path from the same seed differs")
    del sim_main, sim2

    # ---- path 2: the scenario through the lesion, all five kernels ------
    chunks = 12
    from repro_torch.connectome import tree as ctree
    from repro_torch.kernels import activity_fused as af
    from repro_torch.kernels import leaf_sums as ls
    from repro_torch.kernels import synapse_apply as sa
    from repro_torch.kernels import radix_sort as rs
    _build.reset_launch_counts()
    af.device_launches(reset=True)
    sa.device_launches(reset=True)
    rs.morton_device_launches(reset=True)
    sa.route_device_launches(reset=True)
    ls.device_launches(reset=True)
    chash.plain_cuda_calls(reset=True)
    ctree.plain_cuda_calls(reset=True)
    sim, rec, warm, per_chunk, flags = run_main_path(all_fused, chunks - 1,
                                                     scn)
    counts = _build.launch_counts()
    if chash.plain_cuda_calls(reset=True):
        fail("the plain int64 Threefry ran on CUDA tensors on the scenario "
             "path")
    if ctree.plain_cuda_calls(reset=True):
        fail("the plain leaf sums ran on CUDA tensors on the scenario path")
    device_counts = {"activity_window": af.device_launches(reset=True),
                     "synapse_apply": sa.device_launches(reset=True),
                     "morton_sort": rs.morton_device_launches(reset=True),
                     "route_build": sa.route_device_launches(reset=True),
                     "tree_assembly": ls.device_launches(reset=True)}
    keys = check_path("scenario_path", sim, all_fused, warm, per_chunk,
                      flags, counts, scenario=scn, rec=rec,
                      device_counts=device_counts)
    want = {"activity_window": chunks, "morton_sort": chunks,
            "synapse_apply": 3 * chunks, "route_build": 2 * chunks,
            "retract": 2 * chunks, "edge_priority": 0,
            "tree_assembly": chunks}
    for name, k in want.items():
        if counts[name] != k:
            fail(f"{name} launched {counts[name]} times on the scenario "
                 f"path, not {k}")
    if counts["threefry_words"] != 3:
        fail(f"K0 launched {counts['threefry_words']} times on the scenario "
             f"path, not 3 (init_state's draws)")
    if device_counts["activity_window"] != {"staged": chunks,
                                            "streaming": 0} or \
            device_counts["synapse_apply"] != 3 * chunks or \
            device_counts["morton_sort"] != chunks or \
            device_counts["route_build"] != 2 * chunks or \
            device_counts["tree_assembly"] != chunks:
        fail(f"the sources counted {device_counts} device launches on the "
             f"scenario path, not {chunks} staged K1, {3 * chunks} K4, "
             f"{chunks} K3, {2 * chunks} K5 and {chunks} tree assemblies")
    if counts["bh_traverse"] < chunks:
        fail(f"K2 launched {counts['bh_traverse']} times")

    # ---- path 3: four ranks on the one card, the scenario, all fused ----
    sim_r4, r4_counts = multi_rank_path(all_fused, scn, card, chunks)
    torch.cuda.empty_cache()

    # ---- path 4: the paper's comparisons at R=4 (old connectivity, sparse
    # exchange, old spikes against new / dense); then a chunk of each run
    # and of the multi-rank path profiled in one session, the first to
    # profile rank threads (a profiler session slows the host for the rest
    # of the process)
    cmp_runs, _ = comparison_paths(
        cmp_cfg, scaled(scn, 4), card,
        also_profile={"profile_multi_rank_path": sim_r4})
    del sim_r4
    torch.cuda.empty_cache()

    # ---- path 5: the workloads (engram from a loaded connectome, the
    # assimilation loop through step_with, from_connectome at R=4)
    wl_line, leaf = workloads_path(all_fused, card)
    torch.cuda.empty_cache()

    # ---- path 6: the runtime (SimulationRunner: preempt and resume, NaN
    # rollback, a corrupt checkpoint skipped; elastic R=4 -> R=2)
    _, runner_counts = runner_path(all_fused, scn, cmp_cfg, scaled(scn, 4),
                                   card)
    torch.cuda.empty_cache()

    # ---- path 7: the multi-tenant service (six tenants on four slots at
    # R=1, a poisoned slot rolled back; R=4 dense and sparse)
    _, service_counts, service_r4 = service_path(
        all_fused, scn, cmp_cfg, scaled(scn, 4), card)
    torch.cuda.empty_cache()
    # the profiles last: a profiler session slows the host for the rest of
    # the process
    scenario_determinism(sim, rec, all_fused, scn, chunks, keys, card)
    del sim
    # one chunk of the main path profiled (after a warm-up chunk), last:
    # a profiler session slows the host for the rest of the process
    from repro_torch.sim.api import Simulator
    sim = Simulator.from_config(slice_cfg, device=DEV)
    sim.run(1)
    phase_profile({"profile_main_path": sim}, card)
    del sim

    kernels = [
        {"name": "threefry_words", "route": "cuda",
         "source": "src/repro_torch/csrc/hash_words.cu",
         "replaces": "src/repro/kernels/hash.py:57",
         "launches": counts["threefry_words"],
         "multi_rank_launches": r4_counts["threefry_words"],
         "runner_launches": runner_counts["threefry_words"],
         "main_path_launches": main_counts["threefry_words"],
         "max_abs_err": k0["max_abs_err"], "ms": k0["ms"],
         "device_ms": k0["device_ms"], "plain_ms": k0["plain_ms"],
         "bound_ms": k0["bound"][0], "bound_by": k0["bound"][1],
         "library_ms": None,
         "draws": {x["draw"]: {k: x[k] for k in (
             "ms", "device_ms", "plain_ms", "bound_ms", "bound_by")}
             for x in k0_lines}},
        {"name": "retract", "route": "cuda",
         "source": "src/repro_torch/csrc/retract.cu",
         "replaces": "src/repro/connectome/synapses.py:117 (jnp)",
         "launches": counts["retract"],
         "multi_rank_launches": r4_counts["retract"],
         "runner_launches": runner_counts["retract"], "max_abs_err": kr_err,
         "ms": kr_res["full"][0], "device_ms": kr_res["full"][1],
         "plain_ms": kr_res["full"][2], "bound_ms": kr_res["full"][3][0],
         "bound_by": kr_res["full"][3][1], "library_ms": None,
         "scenario_sparse": {
             "ms": kr_res["scenario_sparse"][0],
             "device_ms": kr_res["scenario_sparse"][1],
             "plain_ms": kr_res["scenario_sparse"][2],
             "bound_ms": kr_res["scenario_sparse"][3][0],
             "bound_by": kr_res["scenario_sparse"][3][1]}},
        {"name": "edge_priority", "route": "cuda",
         "source": "src/repro_torch/csrc/retract.cu",
         "replaces": "src/repro/connectome/synapses.py:56 (jnp)",
         "launches": counts["edge_priority"],
         "multi_rank_launches": r4_counts["edge_priority"],
         "runner_launches": runner_counts["edge_priority"],
         "on_the_paths": "drawn inside K4's accept (keyed mode); the "
                         "standalone kernel is the kernel API's",
         "max_abs_err": kr_err,
         "ms": kr_res["priority"][0], "device_ms": kr_res["priority"][1],
         "plain_ms": kr_res["priority"][2],
         "bound_ms": kr_res["priority"][3][0],
         "bound_by": kr_res["priority"][3][1], "library_ms": None},
        {"name": "activity_window", "route": "cuda",
         "source": "src/repro_torch/csrc/activity_window.cu",
         "replaces": "src/repro/kernels/activity_fused.py:279",
         "launches": counts["activity_window"],
         "multi_rank_launches": r4_counts["activity_window"],
         "runner_launches": runner_counts["activity_window"],
         "max_abs_err": max(k1["max_abs_err"], k1s["max_abs_err"]),
         "ms": k1_ms, "device_ms": k1_dev, "plain_ms": k1_plain,
         "bound_ms": k1_bound, "bound_by": k1_by, "library_ms": None,
         "device_launches_per_window": sum(k1_launches.values()),
         "R4": {"ms": k1r4[0], "device_ms": k1r4[1], "plain_ms": k1r4[2],
                "bound_ms": k1r4[3][0], "bound_by": k1r4[3][1]}},
        {"name": "bh_traverse", "route": "cuda",
         "source": "src/repro_torch/csrc/bh_traverse.cu",
         "replaces": "src/repro/kernels/bh_traverse.py:77",
         "launches": counts["bh_traverse"],
         "multi_rank_launches": r4_counts["bh_traverse"],
         "runner_launches": runner_counts["bh_traverse"],
         "max_abs_err": max(k2_abs, r4["K2"][5]),
         "ms": k2_ms, "device_ms": k2_dev, "plain_ms": k2_plain,
         "bound_ms": k2_bound, "bound_by": k2_by, "library_ms": None,
         "R4": {"ms": r4["K2"][0], "device_ms": r4["K2"][1],
                "plain_ms": r4["K2"][2], "bound_ms": r4["K2"][3][0],
                "bound_by": r4["K2"][3][1]}},
        {"name": "morton_sort", "route": "cuda",
         "source": "src/repro_torch/csrc/morton_sort.cu",
         "replaces": "src/repro/kernels/radix_sort.py:135",
         "launches": counts["morton_sort"],
         "multi_rank_launches": r4_counts["morton_sort"],
         "runner_launches": runner_counts["morton_sort"],
         "max_abs_err": max(k3[3], r4["K3"][3]),
         "R4": {"ms": r4["K3"][0], "device_ms": r4["K3"][4],
                "plain_ms": r4["K3"][1], "bound_ms": r4["K3"][2][0],
                "bound_by": r4["K3"][2][1]},
         "ms": k3[0], "device_ms": k3[4], "plain_ms": k3[1],
         "bound_ms": k3[2][0],
         "bound_by": k3[2][1], "library_ms": None,
         "device_launches_per_call": k3[5]},
        {"name": "synapse_apply", "route": "cuda",
         "source": "src/repro_torch/csrc/synapse_apply.cu",
         "replaces": "src/repro/kernels/synapse_apply.py:63",
         "launches": counts["synapse_apply"],
         "multi_rank_launches": r4_counts["synapse_apply"],
         "runner_launches": runner_counts["synapse_apply"],
         "max_abs_err": max(k4["drain"][3], k4["accept"][3],
                            r4["K4"]["drain"][3], r4["K4"]["accept"][3]),
         "R4": {part: {"ms": r4["K4"][part][0],
                       "device_ms": r4["K4"][part][4],
                       "plain_ms": r4["K4"][part][1],
                       "bound_ms": r4["K4"][part][2][0],
                       "bound_by": r4["K4"][part][2][1]}
                for part in ("drain", "accept")},
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
         "launches": counts["route_build"],
         "multi_rank_launches": r4_counts["route_build"],
         "runner_launches": runner_counts["route_build"],
         "max_abs_err": max(k5[3], r4["K5"][3]),
         "R4": {"ms": r4["K5"][0], "device_ms": r4["K5"][4],
                "plain_ms": r4["K5"][1], "bound_ms": r4["K5"][2][0],
                "bound_by": r4["K5"][2][1]},
         "ms": k5[0], "device_ms": k5[4], "plain_ms": k5[1],
         "bound_ms": k5[2][0],
         "bound_by": k5[2][1], "library_ms": None,
         "device_launches_per_call": k5[5]},
        {"name": "tree_assembly", "route": "cuda",
         "source": "src/repro_torch/csrc/leaf_sums.cu",
         "replaces": "src/repro/connectome/tree.py:68 (jnp)",
         "launches": counts["tree_assembly"],
         "multi_rank_launches": r4_counts["tree_assembly"],
         "runner_launches": runner_counts["tree_assembly"],
         "workloads_launches": {
             k: wl_line[k]["launches"]["tree_assembly"]
             for k in ("engram", "assimilation", "from_connectome_R4")},
         "max_abs_err": max(v["max_abs_err"] for v in leaf.values()),
         **{k: leaf["R1"][k] for k in (
             "ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
             "library_ms", "device_launches_per_call")},
         "R4": {k: {f: v[f] for f in (
             "ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
             "library_ms", "clamped_rows", "fullest_leaf", "n_leaf")}
             for k, v in leaf.items() if k != "R1"}},
    ]
    # the comparison paths' kernels (launches: their runs of
    # comparison_paths, the profiled chunks not counted)
    first = cmp_runs
    for mode, key, line in (("gumbel", "gumbel (n, F)", 98),
                            ("normal", "normal (n,)", 105)):
        e = hash_lines[key]
        kernels.append({
            "name": f"threefry_words ({mode})", "route": "cuda",
            "source": "src/repro_torch/csrc/hash_words.cu",
            "replaces": f"src/repro/kernels/hash.py:{line}",
            "launches": sum(r["modes"][mode] for r in first.values()),
            "launches_by_run": {k: r["modes"][mode]
                                for k, r in first.items()},
            "max_abs_err": e["max_abs_err"], "ms": e["ms"],
            "device_ms": e["device_ms"], "plain_ms": e["plain_ms"],
            "bound_ms": e["bound_ms"], "bound_by": e["bound_by"],
            "library_ms": None, "shape": key})
    kernels += [
        {"name": "activity_window (sparse rates)", "route": "cuda",
         "source": "src/repro_torch/csrc/activity_window.cu",
         "replaces": "src/repro/kernels/activity_fused.py:279",
         "launches": first["c"]["counts"]["activity_window"],
         "max_abs_err": k1sp[4], "ms": k1sp[0], "device_ms": k1sp[1],
         "plain_ms": k1sp[2], "bound_ms": k1sp[3][0],
         "bound_by": k1sp[3][1], "library_ms": None},
        {"name": "bh_traverse (global tree)", "route": "cuda",
         "source": "src/repro_torch/csrc/bh_traverse.cu",
         "replaces": "src/repro/kernels/bh_traverse.py:77",
         "launches": first["b"]["counts"]["bh_traverse"],
         "max_abs_err": k2g[5], "ms": k2g[0], "device_ms": k2g[1],
         "plain_ms": k2g[2], "bound_ms": k2g[3][0], "bound_by": k2g[3][1],
         "library_ms": None},
        {"name": "synapse_apply (old accept)", "route": "cuda",
         "source": "src/repro_torch/csrc/synapse_apply.cu",
         "replaces": "src/repro/kernels/synapse_apply.py:63",
         "launches": first["b"]["counts"]["synapse_apply"],
         "max_abs_err": k4old["accept"][3], "ms": k4old["accept"][0],
         "device_ms": k4old["accept"][4], "plain_ms": k4old["accept"][1],
         "bound_ms": k4old["accept"][2][0],
         "bound_by": k4old["accept"][2][1], "library_ms": None},
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
    # K9 on the LM serving path: its launches a prefill (none a decode
    # step) and its times at each model's first attention layer
    for e in kernels:
        if e["name"] == "flash_attention":
            e["lm_serve_path_launches"] = {
                c["arch"]: {"prefill": c["k9_launches"]["prefill"],
                            "decode": c["k9_launches"]["decode"]}
                for c in lm["cells"]}
    for c in lm["cells"]:
        k9 = c["k9"]
        kernels.append({
            "name": f"flash_attention ({c['arch']} prefill)", "route": "cuda",
            "source": "src/repro_torch/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:94",
            "launches": c["k9_launches"]["prefill"]
            + c["k9_launches"]["decode"],
            "launches_per_decode_step": c["k9_launches"]["decode"],
            "max_abs_err": k9["max_abs_err"], "ms": k9["ms"],
            "device_ms": k9["device_ms"], "plain_ms": k9["plain_ms"],
            "bound_ms": k9["bound_ms"], "bound_by": k9["bound_by"],
            "library_ms": k9["library_ms"], "shape": k9["shape"]})
    # the service's launches: its R=1 poisoned run (the K0 draws by mode;
    # the old algorithms' variants do not run in the service cells) and its
    # R=4 runs
    for e in kernels:
        base, _, variant = e["name"].partition(" (")
        variant = variant.rstrip(")")
        if variant in ("gumbel", "normal"):
            e["service_launches"] = service_counts["modes"][variant]
        elif variant == "sparse rates":
            e["service_launches"] = service_r4["sparse"].get(base, 0)
            e["service_launches_run"] = "R=4 sparse"
        else:
            e["service_launches"] = 0 if variant else \
                service_counts.get(base, 0)
        if not variant:
            e["service_R4_launches"] = {ex: c.get(base, 0)
                                        for ex, c in service_r4.items()}
    emit({"phase": "done", "seconds": time.perf_counter() - t_start,
          "card": card})
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["lm_serve_path"]:
        sys.exit(lm_child(sys.argv[2]))
    sys.exit(main())
