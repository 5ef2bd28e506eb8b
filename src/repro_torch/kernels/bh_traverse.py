"""K2: the phase-B Barnes-Hut traversal kernel wrapper.

``bh_traverse`` runs ``csrc/bh_traverse.cu`` on CUDA tensors (a prologue
that packs each real node once a call, then a persistent grid whose blocks
hold the packed tree in shared memory and run one query a warp: frontier
expansion to its fixed point, Gumbel-max sampling with restarts, leaf member
selection), and the plain ``connectome/traverse.py::phase_b_core`` on CPU
tensors, as the JAX package's Pallas kernel runs in interpret mode.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.connectome.traverse import PHASE_B_ROUND_BASE, phase_b_core
from repro_torch.kernels import _build
from repro_torch.kernels import hash as chash

MAX_LEVELS = 16       # levels the kernel's level table holds

launches = _build.LaunchCounter("bh_traverse")


def bh_traverse(counts, cents, members, npos, vac, x, start_cell, src_gid,
                valid, chunk: int, gid_base: int, *, seed: int, sizes,
                theta: float, sigma: float, frontier: int, n_levels: int,
                widths=None):
    """Phase-B search for Q queries against one subtree.

    counts: (L, C) f32; cents: (L, C, 3) f32; members: (n_leaf, M) int32;
    npos: (N, 3) f32; vac: (N,) f32; x: (Q, 3); start_cell/src_gid: (Q,)
    int32; valid: (Q,) bool; sizes: the L per-level cell edge lengths;
    widths: the cells of each level the search can reach (the tree's real
    level widths; by default all C), the only ones the kernel packs.
    Returns (target_gid (Q,) int32, valid (Q,) bool, depth (Q,) int32)."""
    kw = dict(seed=seed, sizes=sizes, theta=theta, sigma=sigma,
              frontier=frontier, n_levels=n_levels)
    if x.device.type != "cuda":
        return phase_b_core(counts, cents, members, npos, vac, x, start_cell,
                            src_gid, valid, chunk, gid_base, **kw)
    if not 8 <= frontier <= 128:
        raise ValueError(f"bh_traverse: frontier_cap {frontier} outside "
                         f"[8, 128]")
    if members.shape[1] > 32:
        raise ValueError("bh_traverse: at most 32 members per leaf")
    if PHASE_B_ROUND_BASE + n_levels > chash.BH_ROUNDS - 1:
        raise ValueError(f"{n_levels} restarts would collide with the "
                         f"member-selection round")
    L, C = counts.shape
    widths = (C,) * L if widths is None else tuple(int(w) for w in widths)
    if cents.shape != (L, C, 3) or len(sizes) != L or L != n_levels or \
            len(widths) != L or not all(0 <= w <= C for w in widths):
        raise ValueError("bh_traverse: counts (L, C), cents (L, C, 3), sizes "
                         "(L,) and widths (L,) (each at most C) must agree "
                         "with n_levels")
    if L > MAX_LEVELS:
        raise ValueError(f"bh_traverse: at most {MAX_LEVELS} levels")
    dev = x.device
    f32, i32 = torch.float32, torch.int32
    counts = counts.to(f32).contiguous()
    cents = cents.to(f32).contiguous()
    members = members.to(i32).contiguous()
    npos = npos.to(f32).contiguous()
    vac = vac.to(f32).contiguous()
    xq = x.to(f32).contiguous()
    start = start_cell.to(i32).contiguous()
    gid = src_gid.to(i32).contiguous()
    vin = valid.to(torch.uint8).contiguous()
    q = xq.shape[0]
    nodes = torch.empty((max(sum(widths), 1), 4), dtype=f32, device=dev)
    tgt = torch.empty(q, dtype=i32, device=dev)
    ok = torch.empty(q, dtype=torch.uint8, device=dev)
    depth = torch.empty(q, dtype=i32, device=dev)
    _build.require_cuda("bh_traverse", counts, cents, members, npos, vac, xq,
                        start, gid, vin, nodes, tgt, ok, depth)
    lib = _build.library()
    _build.check(lib.repro_bh_traverse(
        counts.data_ptr(), cents.data_ptr(), members.data_ptr(),
        npos.data_ptr(), vac.data_ptr(), xq.data_ptr(), start.data_ptr(),
        gid.data_ptr(), vin.data_ptr(), (ctypes.c_float * L)(*sizes),
        (ctypes.c_int * L)(*widths), nodes.data_ptr(), tgt.data_ptr(),
        ok.data_ptr(), depth.data_ptr(), q, L, C, members.shape[1], frontier,
        n_levels, int(chunk), int(gid_base), int(seed) & chash.M32,
        float(theta), float(sigma * sigma), PHASE_B_ROUND_BASE,
        members.shape[0], _build.stream()), "bh_traverse")
    launches.add()
    return tgt, ok.to(torch.bool), depth
