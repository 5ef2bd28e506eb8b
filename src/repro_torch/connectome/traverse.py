"""Vectorized Barnes-Hut partner search (paper §III-B0c / §IV-A).

The paper's recursive search — collect nodes meeting the acceptance
criterion (cell_size / distance < theta), sample one by connection
probability, restart inside it if it is an inner node — run
level-synchronously: a static-size frontier per searching neuron is expanded
in lockstep (rejected nodes are replaced by their 8 children), then one
Gumbel-max sample selects the target; sampling an inner node restarts the
expansion from it. The frontier is capped at F entries; parents whose
children would overflow are kept as coarser candidates.

Every Gumbel draw comes from the counter hash (kernels/hash.py) keyed by
``(seed, BH_DOMAIN, bh_ctr(chunk, round, draw), source_gid)``, the streams of
the reference. ``phase_b_core`` is the plain version of the traversal kernel
K2 (kernels/bh_traverse.py, csrc/bh_traverse.cu).

Distances: ``|x|^2 + |y|^2 - 2<x,y>`` in float32, summed x, y, z in order
(the reference's 8-lane padding adds zeros only); the kernel repeats the same
operations, and no matrix unit (TF32) is involved.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import morton
from repro_torch.kernels import hash as chash
from repro_torch.sim import registry

NEG = -1e30

PHASE_A_ROUND_BASE = 0
PHASE_B_ROUND_BASE = 16
MEMBER_ROUND = chash.BH_ROUNDS - 1


class StackedTree(NamedTuple):
    """Consecutive octree levels for indexed access. counts: (L, C_max);
    centroids: (L, C_max, 3); sizes: tuple of L cell edge lengths."""
    counts: torch.Tensor
    centroids: torch.Tensor
    sizes: tuple
    start_level: int


def level_sizes(n_levels: int, start_level: int):
    return tuple(morton.cell_size(start_level + k) for k in range(n_levels))


def stack_levels(counts_tuple, cents_tuple, start_level: int) -> StackedTree:
    lmax = max(c.shape[0] for c in counts_tuple)
    cs, zs = [], []
    for c, z in zip(counts_tuple, cents_tuple):
        pad = lmax - c.shape[0]
        cs.append(torch.nn.functional.pad(c, (0, pad)))
        zs.append(torch.nn.functional.pad(z, (0, 0, 0, pad)))
    sizes = level_sizes(len(counts_tuple), start_level)
    return StackedTree(torch.stack(cs), torch.stack(zs), sizes, start_level)


def _gauss(d2, sigma: float):
    # a tensor divisor keeps the true division on CUDA (a Python scalar
    # divisor becomes a multiply by its reciprocal there)
    s2 = torch.tensor(sigma * sigma, dtype=torch.float32, device=d2.device)
    return torch.exp(-d2 / s2)


def pairwise_d2(x, y):
    """||x - y||^2 for x: (Q, 3) against y: (Q, K, 3), as
    |x|^2 + |y|^2 - 2<x,y> in float32 with the coordinates summed in order."""
    x = x.to(torch.float32)
    y = y.to(torch.float32)
    xx = (x[:, 0] * x[:, 0] + x[:, 1] * x[:, 1] + x[:, 2] * x[:, 2])[:, None]
    yy = y[..., 0] * y[..., 0] + y[..., 1] * y[..., 1] + y[..., 2] * y[..., 2]
    xy = x[:, None, 0] * y[..., 0] + x[:, None, 1] * y[..., 1] \
        + x[:, None, 2] * y[..., 2]
    return torch.clamp_min(xx + yy - 2.0 * xy, 0.0)


def _level_size_at(sizes, lvl_rel):
    out = torch.full(lvl_rel.shape, sizes[0], dtype=torch.float32,
                     device=lvl_rel.device)
    for k in range(1, len(sizes)):
        out = torch.where(lvl_rel == k, sizes[k], out)
    return out


def _node_stats(tree: StackedTree, lvl_rel, cell, x, sigma):
    """Gather (count, prob-weight, size/dist) for (Q, F) entries."""
    lvl = lvl_rel.to(torch.int64)
    c = cell.to(torch.int64)
    cnt = tree.counts[lvl, c]
    cent = tree.centroids[lvl, c]
    center = cent / torch.clamp_min(cnt, 1e-9)[..., None]
    d2 = pairwise_d2(x, center)
    size = _level_size_at(tree.sizes, lvl_rel)
    crit = size / torch.sqrt(torch.clamp_min(d2, 1e-12))
    prob = cnt * _gauss(d2, sigma)
    return cnt, prob, crit


def _check_caps(frontier: int, round_base: int, restarts: int):
    if frontier > chash.BH_DRAWS:
        raise ValueError(f"frontier_cap {frontier} exceeds the PRNG draw "
                         f"window ({chash.BH_DRAWS})")
    if round_base + restarts > MEMBER_ROUND:
        raise ValueError(f"{restarts} restarts from round base {round_base} "
                         f"would collide with the member-selection round")


def _excl_cumsum(need):
    return torch.cumsum(need, dim=1) - need


def expand_and_sample(tree: StackedTree, x, root_cell, root_rel, src_gid,
                      rnd: int, *, seed: int, chunk: int, theta: float,
                      sigma: float, frontier: int, n_levels: int):
    """One paper 'round': expand from the root node until every frontier
    entry meets the acceptance criterion (or is a deepest-level cell), then
    sample. x: (Q, 3); root_cell, root_rel, src_gid: (Q,). Returns (cell,
    rel_level, valid, overflowed): all (Q,)."""
    q = x.shape[0]
    f = frontier
    last = n_levels - 1
    dev = x.device
    i32 = torch.int32

    at_leaf = root_rel >= last
    child_rel = torch.where(at_leaf, root_rel, root_rel + 1)
    base8 = torch.where(at_leaf, root_cell, root_cell * 8)
    js = torch.arange(8, dtype=i32, device=dev)
    cells = torch.zeros((q, f), dtype=i32, device=dev)
    lvls = torch.zeros((q, f), dtype=i32, device=dev)
    valid = torch.zeros((q, f), dtype=torch.bool, device=dev)
    cells[:, :8] = base8[:, None] + torch.where(at_leaf[:, None], 0,
                                                js[None, :])
    lvls[:, :8] = child_rel[:, None]
    valid[:, :8] = torch.where(at_leaf[:, None], js[None] == 0, True)
    overflow = torch.zeros(q, dtype=torch.bool, device=dev)

    for _ in range(n_levels):
        cnt, prob, crit = _node_stats(tree, lvls, cells, x, sigma)
        nonempty = cnt > 1e-9
        accepted = (crit < theta) | (lvls >= last)
        expand = valid & nonempty & ~accepted
        keepers = valid & ~expand & nonempty
        need = torch.where(expand, 8, torch.where(keepers, 1, 0))
        off = _excl_cumsum(need)
        fits = (off + need) <= f
        # pass 2: overflowing expanders retained as coarse candidates
        need2 = torch.where(expand & fits, 8, torch.where(
            keepers | (expand & ~fits), 1, 0))
        off2 = _excl_cumsum(need2)
        fits2 = (off2 + need2) <= f
        # column f collects the dropped writes and is sliced off
        ncells = torch.zeros((q, f + 1), dtype=i32, device=dev)
        nlvls = torch.zeros((q, f + 1), dtype=i32, device=dev)
        nvalid = torch.zeros((q, f + 1), dtype=torch.bool, device=dev)
        single = (need2 == 1) & fits2
        tgt = torch.where(single, off2, f)
        ncells.scatter_(1, tgt, cells)
        nlvls.scatter_(1, tgt, lvls)
        nvalid.scatter_(1, tgt, single)
        exp8 = (need2 == 8) & fits2
        tgt8 = torch.where(exp8[..., None], off2[..., None] + js, f) \
            .reshape(q, f * 8)
        ncells.scatter_(1, tgt8, (cells[..., None] * 8 + js).reshape(q, -1))
        nlvls.scatter_(1, tgt8, (lvls[..., None] + 1).expand(q, f, 8)
                       .reshape(q, -1))
        nvalid.scatter_(1, tgt8, exp8[..., None].expand(q, f, 8)
                        .reshape(q, -1))
        overflow = overflow | torch.any(expand & ~fits2, dim=1)
        cells, lvls, valid = (ncells[:, :f], nlvls[:, :f],
                              nvalid[:, :f])

    cnt, prob, _ = _node_stats(tree, lvls, cells, x, sigma)
    logits = torch.where(valid & (cnt > 1e-9),
                         torch.log(torch.clamp_min(prob, 1e-30)),
                         torch.full_like(prob, NEG))
    g = chash.gumbel(seed, chash.BH_DOMAIN,
                     chash.bh_ctr(chunk, rnd, torch.arange(f, device=dev))
                     [None, :], src_gid[:, None])
    pick = torch.argmax(logits + g, dim=1)
    qi = torch.arange(q, device=dev)
    any_valid = torch.any(logits > NEG / 2, dim=1)
    return cells[qi, pick], lvls[qi, pick], any_valid, overflow


def bh_search(tree: StackedTree, x, src_gid, start_cell, *, seed: int,
              chunk: int, theta, sigma, frontier, n_levels, round_base=0,
              max_restarts=None):
    """Full search: expand/sample, restarting inside sampled inner nodes
    until a deepest-level cell is returned. Returns (leaf_cell, valid,
    overflow, depth) — depth the rounds run before the query settled."""
    q = x.shape[0]
    dev = x.device
    last = n_levels - 1
    restarts = max_restarts or n_levels
    _check_caps(frontier, round_base, restarts)
    cell = start_cell.to(torch.int32)
    rel = torch.zeros(q, dtype=torch.int32, device=dev)
    valid = torch.ones(q, dtype=torch.bool, device=dev)
    done = torch.zeros(q, dtype=torch.bool, device=dev)
    overflow = torch.zeros(q, dtype=torch.bool, device=dev)
    depth = torch.zeros(q, dtype=torch.int32, device=dev)
    for i in range(restarts):
        ncell, nrel, nvalid, noverf = expand_and_sample(
            tree, x, cell, rel, src_gid, round_base + i, seed=seed,
            chunk=chunk, theta=theta, sigma=sigma, frontier=frontier,
            n_levels=n_levels)
        cell = torch.where(done, cell, ncell)
        rel = torch.where(done, rel, nrel)
        valid = torch.where(done, valid, nvalid)
        overflow = overflow | (~done & noverf)
        depth = depth + (~done).to(torch.int32)
        done = done | (rel >= last) | ~valid
    valid = valid & (rel >= last)
    return cell, valid, overflow, depth


def select_member(x, member_pos, member_weight, member_valid, src_gid, *,
                  seed: int, chunk: int, sigma):
    """Pick an actual neuron within the chosen leaf cell, kernel-weighted.
    member_*: (Q, M, ...). Returns (idx (Q,), valid (Q,))."""
    m = member_pos.shape[1]
    if m > chash.BH_DRAWS:
        raise ValueError(f"members_cap {m} exceeds the PRNG draw window "
                         f"({chash.BH_DRAWS})")
    d2 = pairwise_d2(x, member_pos)
    w = member_weight * _gauss(d2, sigma)
    logits = torch.where(member_valid & (w > 1e-12),
                         torch.log(torch.clamp_min(w, 1e-30)),
                         torch.full_like(w, NEG))
    g = chash.gumbel(seed, chash.BH_DOMAIN,
                     chash.bh_ctr(chunk, MEMBER_ROUND,
                                  torch.arange(m, device=x.device))[None, :],
                     src_gid[:, None])
    pick = torch.argmax(logits + g, dim=1)
    valid = torch.any(logits > NEG / 2, dim=1)
    return pick, valid


# ---------------------------------------------------------------- phase A
def phase_a(top, pos, src_gid, cfg, num_ranks: int, *, chunk: int):
    """Search the replicated tree down to the branch level. Returns
    (branch_cell (Q,), valid (Q,))."""
    b = morton.branch_level(num_ranks)
    q = pos.shape[0]
    if b == 0:
        return (torch.zeros(q, dtype=torch.int32, device=pos.device),
                torch.ones(q, dtype=torch.bool, device=pos.device))
    tree = stack_levels(top.counts, top.centroids, 0)
    cell, valid, _, _ = bh_search(
        tree, pos, src_gid, torch.zeros(q, dtype=torch.int32,
                                        device=pos.device),
        seed=cfg.seed, chunk=chunk, theta=cfg.theta, sigma=cfg.sigma,
        frontier=cfg.frontier_cap, n_levels=b + 1,
        round_base=PHASE_A_ROUND_BASE)
    return cell, valid


# ---------------------------------------------------------------- phase B
def phase_b_core(counts, cents, leaf_members, neuron_pos, vacant_d, x,
                 start_cell_rel, src_gid, valid_in, chunk: int, gid_base: int,
                 *, seed: int, sizes, theta: float, sigma: float,
                 frontier: int, n_levels: int):
    """Finish the search inside one rank's subtree — the plain version of
    the traversal kernel (K2). counts: (L, C); cents: (L, C, 3);
    leaf_members: (n_leaf, M); neuron_pos/vacant_d: the subtree's neurons;
    x/start_cell_rel/src_gid/valid_in: (Q, ...) queries.
    Returns (target_gid (Q,), valid (Q,), depth (Q,) int32)."""
    tree = StackedTree(counts, cents, tuple(sizes), 0)
    leaf_cell, valid, _, depth = bh_search(
        tree, x, src_gid, start_cell_rel, seed=seed, chunk=chunk, theta=theta,
        sigma=sigma, frontier=frontier, n_levels=n_levels,
        round_base=PHASE_B_ROUND_BASE)
    valid = valid & valid_in
    leaf = torch.clamp(leaf_cell.to(torch.int64), 0, leaf_members.shape[0] - 1)
    members = leaf_members[leaf]                       # (Q, M) local ids
    mvalid = members >= 0
    msafe = torch.where(mvalid, members, 0)
    mgid = gid_base + msafe
    # exclude self-connection (a neuron never proposes to itself)
    mvalid = mvalid & (mgid != src_gid[:, None])
    ms64 = msafe.to(torch.int64)
    mpos = neuron_pos[ms64]
    mw = torch.where(mvalid, vacant_d[ms64], 0.0)
    pick, pvalid = select_member(x, mpos, mw, mvalid, src_gid, seed=seed,
                                 chunk=chunk, sigma=sigma)
    tgt_local = torch.gather(msafe, 1, pick[:, None])[:, 0]
    tgt_gid = gid_base + tgt_local
    ok = valid & pvalid
    return torch.where(ok, tgt_gid, -1).to(torch.int32), ok, depth


@registry.register_phase("traversal", "reference")
def phase_b_reference(stacked, local, neuron_pos, vacant_d, pos,
                      start_cell_rel, src_gid, valid_in, chunk, gid_base, kw):
    """The plain ``phase_b_core`` over the full query batch."""
    return phase_b_core(stacked.counts, stacked.centroids,
                        local.leaf_members, neuron_pos, vacant_d, pos,
                        start_cell_rel, src_gid, valid_in, chunk, gid_base,
                        **kw)


@registry.register_phase("traversal", "fused")
def phase_b_fused(stacked, local, neuron_pos, vacant_d, pos, start_cell_rel,
                  src_gid, valid_in, chunk, gid_base, kw):
    """The traversal kernel K2 (kernels/bh_traverse.py), packing only the
    tree's real level widths."""
    from repro_torch.kernels import bh_traverse   # lazy: it imports us
    return bh_traverse.bh_traverse(
        stacked.counts, stacked.centroids, local.leaf_members, neuron_pos,
        vacant_d, pos, start_cell_rel, src_gid, valid_in, chunk, gid_base,
        widths=tuple(c.shape[0] for c in local.counts), **kw)


def phase_b(local, neuron_pos, vacant_d, pos, src_gid, start_cell_rel,
            valid_in, cfg, num_ranks: int, gid_base: int, *, chunk: int):
    """Phase-B dispatch per ``cfg.connectivity_impl`` ('reference' |
    'fused')."""
    b = morton.branch_level(num_ranks)
    stacked = stack_levels(local.counts, local.centroids, b)
    kw = dict(seed=cfg.seed, sizes=stacked.sizes, theta=cfg.theta,
              sigma=cfg.sigma, frontier=cfg.frontier_cap,
              n_levels=cfg.local_levels + 1)
    impl = registry.resolve("traversal", cfg.connectivity_impl)
    return impl(stacked, local, neuron_pos, vacant_d, pos, start_cell_rel,
                src_gid, valid_in, chunk, gid_base, kw)
