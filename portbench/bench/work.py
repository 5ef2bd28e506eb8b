"""The work a kernel or a step needs, counted from the inputs' shapes and
values, whatever code computes it.

Copied from ``chip_smoke.py``: the operation counts of one Threefry-2x32
(``HASH_OPS``), of K1's neuron step and a used slot of its row
(``NEURON_OPS``, ``SLOT_OPS``) and K1's bytes (``k1_timing``); K2's node
statistics and Gumbel logs (``NODE_OPS``, ``GUMBEL_LOG_OPS``), its bytes
and the replay of the search that counts the node evaluations and draws
these inputs need (``k2_work``, here over the plain reference's search
functions and in blocks of queries); ``attention_pairs`` (which is
``_bwd_pairs`` of a causal call); K9's forward and backward flops and bytes
(``k9_fwd_lse_check``, ``k9_bwd_check``); the model flops of a training
step (``lm_train_cell``: 6 N T plus the attention's 3 x 4 D flops a valid
pair, head and layer; the recomputed forward of remat not counted). N here
leaves out the input embedding table, whose lookup multiplies nothing.
"""
from __future__ import annotations

import torch

from portbench.reference import msp

HASH_OPS = 67
NEURON_OPS = 60
SLOT_OPS = 6
NODE_OPS = 24
GUMBEL_LOG_OPS = 20


def k1_window(n: int, s: int, steps: int, valid_edges: int,
              lesions: bool) -> dict:
    """K1's work over one window of ``steps`` at one rank (every edge
    local, the rates table (1, n)): a noise draw a neuron and SLOT_OPS a
    used slot a step; the neuron arithmetic; the state, table and rates
    read and written once."""
    nbytes = (25 * n + 4 * n * s + 4 * n + 4 * n + 8 * n + 24 * n + 25 * n
              + 4 * steps + (n if lesions else 0))
    return {"bytes": nbytes,
            "int_ops": steps * (n * HASH_OPS + valid_edges * SLOT_OPS),
            "fp_ops": steps * n * NEURON_OPS}


def k2_work(tree, members, neuron_pos, vacant_d, x, start, src_gid, cfg,
            chunk: int, block: int = 1 << 17) -> dict:
    """Node evaluations, frontier and member Gumbel draws and sub-round
    entries that the search over these inputs needs (``chip_smoke.k2_work``
    replayed with the plain reference's search)."""
    counts_, cents, sizes = tree
    f, n_levels = cfg["frontier_cap"], cfg["local_levels"] + 1
    theta, sigma = cfg["theta"], cfg["sigma"]
    last = n_levels - 1
    dev = x.device
    i32 = torch.int32
    js = torch.arange(8, dtype=i32, device=dev)
    tot = {"queries": 0, "rounds": 0, "node_evaluations": 0,
           "frontier_draws": 0, "member_draws": 0, "subround_entries": 0}
    for lo in range(0, x.shape[0], block):
        xs, gid = x[lo:lo + block], src_gid[lo:lo + block]
        q = xs.shape[0]
        cell = start[lo:lo + block].to(i32)
        rel = torch.zeros(q, dtype=i32, device=dev)
        done = torch.zeros(q, dtype=torch.bool, device=dev)
        evals = draws = entries = rounds = 0
        for i in range(n_levels):
            active = ~done
            rounds += int(active.sum())
            at_leaf = rel >= last
            cells = torch.zeros((q, f), dtype=i32, device=dev)
            lvls = torch.zeros((q, f), dtype=i32, device=dev)
            ok = torch.zeros((q, f), dtype=torch.bool, device=dev)
            cells[:, :8] = torch.where(at_leaf, cell, cell * 8)[:, None] + \
                torch.where(at_leaf[:, None], 0, js[None, :])
            lvls[:, :8] = torch.where(at_leaf, rel, rel + 1)[:, None]
            ok[:, :8] = torch.where(at_leaf[:, None], js[None] == 0, True)
            evals += int((ok & active[:, None]).sum())
            settled = torch.zeros(q, dtype=torch.bool, device=dev)
            for _ in range(n_levels):
                cnt, _, crit = msp.node_stats(counts_, cents, sizes, lvls,
                                              cells, xs, sigma)
                nonempty = cnt > 1e-9
                expand = ok & nonempty & ~((crit < theta) | (lvls >= last))
                keep = ok & ~expand & nonempty
                need = torch.where(expand, 8, torch.where(keep, 1, 0))
                fits = msp._excl_cumsum(need) + need <= f
                need2 = torch.where(expand & fits, 8,
                                    torch.where(keep | (expand & ~fits), 1, 0))
                off2 = msp._excl_cumsum(need2)
                need2 = torch.where(off2 + need2 <= f, need2, 0)
                run = active & ~settled
                entries += int((ok & run[:, None]).sum())
                settled = settled | ~torch.any(ok & (need2 != 1), dim=1)
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
                cells, lvls, ok = nc[:, :f], nl[:, :f], nv[:, :f]
            cnt, _, _ = msp.node_stats(counts_, cents, sizes, lvls, cells,
                                       xs, sigma)
            live = ok & (cnt > 1e-9)
            draws += int((live & active[:, None]).sum())
            ncell, nrel, nvalid = msp.expand_and_sample(
                tree, xs, cell, rel, gid, msp.PHASE_B_ROUND_BASE + i, cfg,
                chunk)
            cell = torch.where(done, cell, ncell)
            rel = torch.where(done, rel, nrel)
            done = done | (rel >= last) | ~nvalid
        leaf = torch.clamp(cell.to(torch.int64), 0, members.shape[0] - 1)
        mem = members[leaf]
        msafe = torch.where(mem >= 0, mem, 0).to(torch.int64)
        mvalid = (mem >= 0) & (msafe != gid[:, None])
        w = torch.where(mvalid, vacant_d[msafe], 0.0) * msp._gauss(
            msp.pairwise_d2(xs, neuron_pos[msafe]), sigma)
        tot["queries"] += q
        tot["rounds"] += rounds
        tot["node_evaluations"] += evals
        tot["frontier_draws"] += draws
        tot["member_draws"] += int((mvalid & (w > 1e-12)).sum())
        tot["subround_entries"] += entries
    return tot


def k2_bound_inputs(work: dict, input_bytes: int, widths, q: int) -> dict:
    """K2's bound terms (``chip_smoke.k2_compare_and_time``): the inputs
    read once, the packed tree (16 bytes a node) and 9 bytes out a query;
    a Threefry and two logs a draw, NODE_OPS a node evaluation."""
    draws = work["frontier_draws"] + work["member_draws"]
    return {"bytes": input_bytes + 16 * sum(widths) + q * 9,
            "int_ops": draws * HASH_OPS,
            "fp_ops": work["node_evaluations"] * NODE_OPS
            + draws * GUMBEL_LOG_OPS}


def attention_pairs(s: int, skv: int, window: int) -> int:
    """Unmasked (q, k) pairs of causal attention with top-left positions."""
    total = 0
    for q in range(s):
        hi = min(q, skv - 1)
        lo = max(q - window + 1, 0) if window > 0 else 0
        total += max(hi - lo + 1, 0)
    return total


def k9_forward(b, hq, hkv, s, d, window=0) -> dict:
    """K9's forward with its logsumexp (the training path), bf16: 4 D flops
    a valid pair and head; q and o, k and v, and the f32 logsumexp, each
    once."""
    pairs = attention_pairs(s, s, window) * b * hq
    q_el, kv_el = b * hq * s * d, b * hkv * s * d
    return {"flops": 4 * d * pairs,
            "bytes": (2 * q_el + 2 * kv_el) * 2 + 4 * b * hq * s}


def k9_backward(b, hq, hkv, s, d, window=0) -> dict:
    """K9's backward, bf16: five products of 2 D flops a valid pair and
    head; q, o, dO, dq in and out once, k, v, dk, dv once, the logsumexp."""
    pairs = attention_pairs(s, s, window) * b * hq
    q_el, kv_el = b * hq * s * d, b * hkv * s * d
    return {"flops": 5 * 2 * d * pairs,
            "bytes": 2 * (3 * q_el + 2 * kv_el + 2 * kv_el) + 4 * b * hq * s}


def train_step_flops(n_params: int, tokens: int, batch: int, seq: int,
                     heads: int, head_dim: int, layers: int,
                     window: int = 0) -> int:
    """Model flops of one training step: 6 N T plus the attention's
    3 x 4 D flops a valid pair, head and layer."""
    pairs = attention_pairs(seq, seq, window) * batch
    return 6 * n_params * tokens + 3 * 4 * head_dim * pairs * heads * layers
