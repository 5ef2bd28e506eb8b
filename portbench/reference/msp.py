"""The plain reference of the MSP brain: one rank (R=1), the new algorithms
and the dense rate exchange, in plain PyTorch.

A frozen copy of the plain versions in ``repro_torch`` (the program under
test), so that later changes to the program cannot move the yardstick.
It imports nothing of the program and runs the same float operations in
the same order, element by element, so the fused path's state must equal
it bit for bit. Where it departs from the copied code, it does so without
changing a result:

- at one rank every in-edge is local, so the counter-hash draw of remote
  spikes (``activity_fused.reconstruct_remote_spikes``), whose hits are all
  masked off there, is not computed;
- the tree's leaf sums are always the plain dense-table sums
  (``tree.assemble_plain``; the program runs its assembly kernel there);
- the pairwise retraction ranks, the Barnes-Hut search and the member pick
  run over blocks of rows or queries (each row is computed on its own, so
  the blocks give the same values) to bound the temporaries at millions of
  neurons.

Sources (``src/repro_torch/``): ``kernels/hash.py`` (Threefry-2x32 and the
counter-hash draws), ``prng.py`` (``jax.random``'s derivations),
``core/morton.py``, ``core/engine.py::init_state``,
``core/neuron.py::init_neurons`` / ``refresh_rate``,
``kernels/activity_fused.py::step_core`` / ``window_plain``,
``connectome/update.py``, ``connectome/synapses.py``,
``connectome/routing.py``, ``connectome/tree.py``,
``connectome/traverse.py``, ``scenarios/{populations,regions,protocol,
observables}.py``.

``precision="bfloat16"`` rounds the neuron state to bfloat16 after every
activity step: the control that a check of ``correct`` must refuse.
"""
from __future__ import annotations

import math

import numpy as np
import torch

M32 = 0xFFFFFFFF
NOISE_DOMAIN = 0x6E6F6973
BH_DOMAIN = 0x62687472
BH_ROUNDS = 64
BH_DRAWS = 128
PHASE_B_ROUND_BASE = 16
MEMBER_ROUND = BH_ROUNDS - 1
NEG = -1e30
_PARITY = 0x1BD11BDA
_ROT_A = (13, 15, 26, 6)
_ROT_B = (17, 29, 16, 24)
_TWO_PI = 2.0 * 3.14159265358979
_ONE_BITS = 0x3F800000
_NEVER = 1 << 30
F32 = torch.float32
I32 = torch.int32
I64 = torch.int64

# rows or queries a block (bounds the temporaries; any size gives the same
# values)
ROW_BLOCK = 1 << 18
QUERY_BLOCK = 1 << 18

STATE_FIELDS = ("v", "u", "calcium", "ax_elements", "de_elements", "spiked",
                "spike_count", "rate", "is_excitatory", "out_edges",
                "in_edges", "positions", "rates_table")


# ------------------------------------------------------------ Threefry-2x32
def _u32(x, device):
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=I64) & M32
    return torch.tensor(int(x) & M32, dtype=I64, device=device)


def _rotl(x, r: int):
    return ((x << r) & M32) | (x >> (32 - r))


def threefry2x32(k0, k1, c0, c1, device):
    """20-round Threefry-2x32 on int64 tensors holding u32 words."""
    k0, k1, x0, x1 = (_u32(v, device) for v in (k0, k1, c0, c1))
    k2 = k0 ^ k1 ^ _PARITY
    ks = (k0, k1, k2)
    x0 = (x0 + k0) & M32
    x1 = (x1 + k1) & M32
    for g in range(5):
        for r in (_ROT_A if g % 2 == 0 else _ROT_B):
            x0 = (x0 + x1) & M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(g + 1) % 3]) & M32
        x1 = (x1 + ks[(g + 2) % 3] + (g + 1)) & M32
    return x0, x1


def threefry2x32_int(k0: int, k1: int, c0: int, c1: int):
    ks = (k0 & M32, k1 & M32, (k0 ^ k1 ^ _PARITY) & M32)
    x0 = (c0 + ks[0]) & M32
    x1 = (c1 + ks[1]) & M32
    for g in range(5):
        for r in (_ROT_A if g % 2 == 0 else _ROT_B):
            x0 = (x0 + x1) & M32
            x1 = (((x1 << r) & M32) | (x1 >> (32 - r))) ^ x0
        x0 = (x0 + ks[(g + 1) % 3]) & M32
        x1 = (x1 + ks[(g + 2) % 3] + g + 1) & M32
    return x0, x1


def _to_unit(word):
    return (word >> 8).to(F32) * (2.0 ** -24)


def hash_uniform(seed, domain, ctr, entity, device):
    x0, _ = threefry2x32(seed, domain, ctr, entity, device)
    return _to_unit(x0)


def gumbel(seed, domain, ctr, entity, device):
    u = hash_uniform(seed, domain, ctr, entity, device)
    return -torch.log(-torch.log(torch.clamp_min(u, 1e-20)))


def normal(seed, domain, ctr, entity, device):
    x0, x1 = threefry2x32(seed, domain, ctr, entity, device)
    u1 = _to_unit(x0)
    u2 = _to_unit(x1)
    r = torch.sqrt(-2.0 * torch.log1p(-u1))
    return r * torch.cos(_TWO_PI * u2)


def bh_ctr(chunk, rnd, draw):
    return ((int(chunk) * BH_ROUNDS + rnd) * BH_DRAWS + draw.to(I64)) & M32


# ------------------------------------------------- jax.random's derivations
def key_words(seed: int):
    return (0, int(seed) & M32)


def fold_in_words(k, data: int):
    return threefry2x32_int(k[0], k[1], 0, int(data) & M32)


def split_words(k, num: int = 2):
    return tuple(threefry2x32_int(k[0], k[1], 0, i) for i in range(num))


def key_tensor(words, device):
    return torch.tensor([int(words[0]) & M32, int(words[1]) & M32],
                        dtype=I64, device=device)


def _hash_key(k, c0, c1, device):
    x0, x1 = threefry2x32(k[..., 0], k[..., 1], c0, c1, device)
    return torch.stack(torch.broadcast_tensors(x0, x1), dim=-1)


def fold_in(k, data):
    """``jax.random.fold_in`` of a key tensor by an integer tensor."""
    k = k.expand(*data.shape, 2) if k.dim() == 1 else k
    return _hash_key(k, 0, data.to(I64) & M32, k.device)


def split(k, num: int = 2):
    i = torch.arange(num, dtype=I64, device=k.device)
    return _hash_key(k[None, :], 0, i, k.device)


def random_bits(k, shape):
    i = torch.arange(math.prod(shape), dtype=I64, device=k.device)
    x0, x1 = threefry2x32(k[0], k[1], i >> 32, i & M32, k.device)
    return (x0 ^ x1).reshape(shape)


def _bits_to_unit(b):
    return ((b >> 9) | _ONE_BITS).to(I32).view(F32) - 1.0


def _fma_f32(x, span: float, lo: float):
    """float32 ``x * span + lo`` rounded once (round-to-odd in float64)."""
    p = x.to(torch.float64) * span
    s = p + lo
    b = s - p
    err = (p - (s - b)) + (lo - b)
    bits = s.view(I64)
    toward = torch.where((err > 0) == (s > 0), 1, -1)
    bits = torch.where((err != 0) & ((bits & 1) == 0), bits + toward, bits)
    return bits.view(torch.float64).to(F32)


def _bounds(minval: float, maxval: float):
    lo = torch.tensor(minval, dtype=F32)
    hi = torch.tensor(maxval, dtype=F32)
    return float(lo), float(hi - lo)


def uniform(k, shape=(), minval: float = 0.0, maxval: float = 1.0):
    lo, span = _bounds(minval, maxval)
    if k.dim() > 1:
        x0, x1 = threefry2x32(k[..., 0], k[..., 1], 0, 0, k.device)
        floats = _bits_to_unit(x0 ^ x1)
    else:
        floats = _bits_to_unit(random_bits(k, tuple(shape)))
    return torch.clamp_min(_fma_f32(floats, span, lo), lo)


def randint(k, shape, minval: int, maxval: int):
    span = (maxval - minval) & M32 if maxval > minval else 1
    multiplier = (2 ** 16) % span
    multiplier = ((multiplier * multiplier) & M32) % span
    k1, k2 = split(k)
    higher = random_bits(k1, tuple(shape))
    lower = random_bits(k2, tuple(shape))
    off = ((higher % span) * multiplier) & M32
    off = ((off + lower % span) & M32) % span
    return (minval + off).to(I32)


# ------------------------------------------------------------------ Morton
def _part1by2(x):
    x = x.to(I64) & 0x3FF
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    x = (x | (x << 2)) & 0x09249249
    return x


def _compact1by2(x):
    x = x.to(I64) & 0x09249249
    x = (x ^ (x >> 2)) & 0x030C30C3
    x = (x ^ (x >> 4)) & 0x0300F00F
    x = (x ^ (x >> 8)) & 0x030000FF
    x = (x ^ (x >> 16)) & 0x000003FF
    return x


def morton_encode(pos, level: int):
    g = 1 << level
    ijk = torch.clamp((pos * g).to(I32), 0, g - 1)
    code = (_part1by2(ijk[..., 0]) | (_part1by2(ijk[..., 1]) << 1)
            | (_part1by2(ijk[..., 2]) << 2))
    return code.to(I32)


def morton_cell_center(cell, level: int):
    c = cell.to(I64) & 0xFFFFFFFF
    ijk = torch.stack([_compact1by2(c), _compact1by2(c >> 1),
                       _compact1by2(c >> 2)], dim=-1)
    return (ijk.to(F32) + 0.5) / float(1 << level)


def cell_size(level: int) -> float:
    return 1.0 / (1 << level)


# ------------------------------------------------ populations, regions
def population_table(cfg, n: int, device):
    """The default two-population table (RS excitatory and inhibitory at
    ``fraction_excitatory``), as (n,) tensors."""
    fr = [cfg["fraction_excitatory"]]
    exc = [True]
    if cfg["fraction_excitatory"] < 1.0:
        fr.append(1.0 - cfg["fraction_excitatory"])
        exc.append(False)
    fr = np.asarray(fr, np.float64)
    bounds = np.floor(np.cumsum(fr) * n).astype(np.int64)
    bounds[-1] = n
    sizes = np.diff(np.concatenate([[0], bounds]))

    def col(value, signed=False):
        vals = [np.full(int(sz), (value if e or not signed else -value),
                        np.float32) for e, sz in zip(exc, sizes)]
        return torch.from_numpy(np.concatenate(vals)).to(device)

    return {"izh_a": col(cfg["izh_a"]), "izh_b": col(cfg["izh_b"]),
            "izh_c": col(cfg["izh_c"]), "izh_d": col(cfg["izh_d"]),
            "target_calcium": col(cfg["target_calcium"]),
            "growth_rate": col(cfg["element_growth_rate"]),
            "synapse_weight": col(cfg["synapse_weight"], signed=True),
            "is_excitatory": torch.from_numpy(
                np.repeat(np.asarray(exc), sizes)).to(device)}


def region_mask(positions, region):
    lo = torch.tensor(region["lo"], dtype=F32, device=positions.device)
    hi = torch.tensor(region["hi"], dtype=F32, device=positions.device)
    return torch.all((positions >= lo) & (positions < hi), dim=-1)


def _region(regions, name):
    for r in regions:
        if r["name"] == name:
            return r
    raise KeyError(f"unknown region {name!r}")


def _lesion_windows(scenario):
    events, regions = scenario["events"], scenario["regions"]
    out = []
    for ev in events:
        if ev["kind"] != "lesion":
            continue
        t1 = min((r["t"] for r in events if r["kind"] == "recover"
                  and r["region"] == ev["region"] and r["t"] > ev["t"]),
                 default=_NEVER)
        out.append((_region(regions, ev["region"]), ev["t"], t1))
    return out


def stim_tables(scenario, positions):
    evs = [e for e in scenario["events"] if e["kind"] == "stimulate"] \
        if scenario else []
    if not evs:
        return None
    masks = torch.stack([region_mask(positions, _region(
        scenario["regions"], e["region"])).to(F32) for e in evs])
    return masks, tuple((float(e["amplitude"]), int(e["t0"]), int(e["t1"]))
                        for e in evs)


def lesion_tables(scenario, positions):
    windows = _lesion_windows(scenario) if scenario else []
    if not windows:
        return None
    masks = torch.stack([region_mask(positions, r) for r, _, _ in windows])
    return masks, tuple((int(t0), int(t1)) for _, t0, t1 in windows)


def alive_mask(scenario, positions, step: int):
    windows = _lesion_windows(scenario) if scenario else []
    if not windows:
        return None
    alive = torch.ones(positions.shape[0], dtype=torch.bool,
                       device=positions.device)
    for region, t0, t1 in windows:
        if t0 <= step < t1:
            alive = alive & ~region_mask(positions, region)
    return alive


def assign_regions(positions, regions):
    rid = torch.full((positions.shape[0],), len(regions), dtype=I32,
                     device=positions.device)
    for i in reversed(range(len(regions))):
        rid = torch.where(region_mask(positions, regions[i]),
                          torch.tensor(i, dtype=I32, device=positions.device),
                          rid)
    return rid


# ------------------------------------------------------------------- init
def init_state(cfg, device, scenario=None):
    """The state the program's ``engine.init_state`` draws at rank 0 of
    one: a dict of tensors and ``chunk`` 0."""
    n = cfg["neurons_per_rank"]
    key = fold_in_words(key_words(cfg["seed"]), 0)
    kp, kn = split_words(key)
    # positions: rank 0 of one owns the one branch cell (level 0)
    kc, kpos = split_words(kp)
    cells = randint(key_tensor(kc, device), (n,), 0, 1)
    centers = morton_cell_center(cells, 0)
    off = (uniform(key_tensor(kpos, device), (n, 3)) - 0.5) * cell_size(0)
    pos = torch.clamp(centers + off, 0.0, 1.0 - 1e-6)
    table = population_table(cfg, n, device)
    k1, _ = split_words(kn)
    vac = uniform(key_tensor(k1, device), (n, 2),
                  minval=cfg["initial_vacant_low"],
                  maxval=cfg["initial_vacant_high"])
    edges = torch.full((n, cfg["max_synapses"]), -1, dtype=I32,
                       device=device)
    state = {
        "v": table["izh_c"].clone(),
        "u": table["izh_b"] * table["izh_c"],
        "calcium": torch.zeros(n, dtype=F32, device=device),
        "ax_elements": vac[:, 0].contiguous(),
        "de_elements": vac[:, 1].contiguous(),
        "spiked": torch.zeros(n, dtype=torch.bool, device=device),
        "spike_count": torch.zeros(n, dtype=F32, device=device),
        "rate": torch.zeros(n, dtype=F32, device=device),
        "is_excitatory": table["is_excitatory"],
        "out_edges": edges, "in_edges": edges.clone(), "positions": pos,
        "rates_table": torch.zeros((1, n), dtype=F32, device=device),
        "chunk": 0}
    return state


# --------------------------------------------------------------- activity
def _wrap_i32(x: int) -> int:
    return ((int(x) + 2 ** 31) % 2 ** 32) - 2 ** 31


def step_core(st, in_edges, table, cfg, gstep: int, stim, lesions):
    """One electrical step at rank 0 of one (every in-edge local)."""
    v, u, ca, ax, de, spiked, spike_count = st
    n = v.shape[0]
    dev = v.device
    a, b, c, d, nu, eps = (table[k] for k in (
        "izh_a", "izh_b", "izh_c", "izh_d", "growth_rate", "target_calcium"))
    valid = in_edges >= 0
    src_lid = torch.where(valid, torch.remainder(in_edges, n), 0)
    local_in = valid & spiked[src_lid]
    src_lid = torch.remainder(torch.where(valid, in_edges, 0), n)
    weights = torch.where(valid, table["synapse_weight"][src_lid], 0.0)
    syn_in = torch.sum(local_in.to(F32) * weights, dim=-1)
    gid = torch.arange(n, dtype=I64, device=dev)
    noise = cfg["background_mean"] + cfg["background_std"] * normal(
        cfg["seed"], NOISE_DOMAIN, gstep, gid, dev)
    step = _wrap_i32(gstep)
    if stim is not None:
        masks, meta = stim
        for i, (amp, t0, t1) in enumerate(meta):
            active = torch.tensor(float(t0 <= step < t1), dtype=F32,
                                  device=dev)
            noise = noise + amp * active * masks[i]
    alive = None
    if lesions is not None:
        masks, meta = lesions
        alive = torch.ones(n, dtype=torch.bool, device=dev)
        for i, (t0, t1) in enumerate(meta):
            if t0 <= step < t1:
                alive = alive & ~masks[i]
    u_prev = u
    i_t = syn_in + noise
    for _ in range(2):
        v = v + 0.5 * (0.04 * v * v + 5.0 * v + 140.0 - u + i_t)
    u = u + a * (b * v - u)
    fired = v >= 30.0
    v = torch.where(fired, c, v)
    u = torch.where(fired, u + d, u)
    if alive is not None:
        fired = fired & alive
        v = torch.where(alive, v, c)
        u = torch.where(alive, u, u_prev)
    firedf = fired.to(F32)
    ca = ca + (-ca * cfg["calcium_decay"] + cfg["calcium_beta"] * firedf)
    spike_count = spike_count + firedf
    drive = nu * (1.0 - ca / eps)
    ax = torch.clamp_min(ax + drive, 0.0)
    de = torch.clamp_min(de + drive, 0.0)
    if alive is not None:
        ax = torch.where(alive, ax, 0.0)
        de = torch.where(alive, de, 0.0)
    return v, u, ca, ax, de, fired, spike_count


def _round_bf16(st):
    """The control's precision: the float state stored in bfloat16."""
    return tuple(x.to(torch.bfloat16).to(F32) if x.dtype == F32 else x
                 for x in st)


def activity_window(state, table, cfg, scenario, precision="float32"):
    st = tuple(state[k] for k in ("v", "u", "calcium", "ax_elements",
                                  "de_elements", "spiked", "spike_count"))
    stim = stim_tables(scenario, state["positions"])
    lesions = lesion_tables(scenario, state["positions"])
    steps = cfg["rate_period"]
    for t in range(steps):
        st = step_core(st, state["in_edges"], table, cfg,
                       state["chunk"] * steps + t, stim, lesions)
        if precision == "bfloat16":
            st = _round_bf16(st)
    out = dict(state)
    out.update(zip(("v", "u", "calcium", "ax_elements", "de_elements",
                    "spiked", "spike_count"), st))
    return out


# -------------------------------------------------------------- synapses
def positions_within(ids, num_buckets: int):
    n = ids.shape[0]
    order = torch.argsort(ids, stable=True)
    sorted_ids = ids[order].contiguous()
    buckets = torch.arange(num_buckets, dtype=sorted_ids.dtype,
                           device=ids.device)
    first = torch.searchsorted(sorted_ids, buckets, side="left")
    ranks = torch.arange(n, dtype=I64, device=ids.device) \
        - first[sorted_ids.to(I64)]
    out = torch.empty(n, dtype=I32, device=ids.device)
    out[order] = ranks.to(I32)
    return out


def counts(edges):
    return torch.sum(edges >= 0, dim=1, dtype=I32)


def compact(edges):
    n, s_max = edges.shape
    occ = edges >= 0
    dst = torch.cumsum(occ, dim=1) - 1
    out = torch.full((n, s_max + 1), -1, dtype=edges.dtype,
                     device=edges.device)
    out.scatter_(1, torch.where(occ, dst, s_max), edges)
    return out[:, :s_max].contiguous()


def lexsort(keys):
    order = torch.argsort(keys[0], stable=True)
    for k in keys[1:]:
        order = order[torch.argsort(k[order], stable=True)]
    return order


def edge_priority(key, a_gid, b_gid):
    return uniform(fold_in(fold_in(key, a_gid), b_gid))


def accept_requests(tgt_lid, src_gid, valid, vacant_d, in_edges, key):
    n, s_max = in_edges.shape
    q = tgt_lid.shape[0]
    prio = edge_priority(key, torch.where(valid, src_gid, 0),
                         torch.where(valid, tgt_lid, 0))
    lid = torch.where(valid, tgt_lid, n)
    order = lexsort((prio, lid))
    rank_p = positions_within(lid[order], n + 1)
    rank_in_tgt = torch.empty(q, dtype=I32, device=lid.device)
    rank_in_tgt[order] = rank_p
    lid_c = torch.clamp(lid, 0, n - 1).to(I64)
    base = counts(in_edges)
    free = s_max - base
    cap = torch.minimum(torch.floor(torch.where(valid, vacant_d[lid_c], 0.0)),
                        free[lid_c].to(F32))
    accept = valid & (rank_in_tgt < cap)
    slot = torch.where(accept, base[lid_c] + rank_in_tgt, s_max)
    new_in = torch.cat([in_edges, torch.full((n, 1), -1, dtype=in_edges.dtype,
                                             device=in_edges.device)], 1)
    new_in[lid_c, slot.to(I64)] = torch.where(
        accept, src_gid.to(in_edges.dtype), -1)
    return accept, new_in[:, :s_max].contiguous()


def add_out_edges(out_edges, tgt_gid, accept):
    n, s_max = out_edges.shape
    base = counts(out_edges)
    slot = torch.where(accept & (base < s_max), base, s_max)
    out = torch.cat([out_edges, torch.full((n, 1), -1, dtype=out_edges.dtype,
                                           device=out_edges.device)], 1)
    rows = torch.arange(n, device=out_edges.device)
    out[rows, slot.to(I64)] = torch.where(accept, tgt_gid.to(out_edges.dtype),
                                          -1)
    return out[:, :s_max].contiguous()


def retract_synapses(key, edges, n_delete, row_gids):
    """The ``n_delete[i]`` lowest-priority occupied slots of row i broken,
    (priority, slot) ranks over the (S, S) comparisons, a block of rows at
    a time."""
    n, s_max = edges.shape
    key = key_tensor(key, edges.device)
    ar = torch.arange(s_max, device=edges.device)
    new, kill = [], []
    for lo in range(0, n, ROW_BLOCK):
        e = edges[lo:lo + ROW_BLOCK]
        occupied = e >= 0
        flat = edge_priority(
            key, torch.broadcast_to(row_gids[lo:lo + ROW_BLOCK, None],
                                    e.shape).reshape(-1),
            torch.where(occupied, e, 0).reshape(-1))
        prio = torch.where(occupied, flat.reshape(e.shape), 2.0)
        lt = prio[:, :, None] < prio[:, None, :]
        tie = (prio[:, :, None] == prio[:, None, :]) & \
            (ar[:, None] < ar[None, :])
        ranks = torch.sum(lt | tie, dim=1)
        k = occupied & (ranks < n_delete[lo:lo + ROW_BLOCK, None])
        new.append(torch.where(k, -1, e))
        kill.append(k)
    return torch.cat(new), torch.cat(kill)


def remove_edges_by_messages(edges, msg_lid, msg_gid, msg_valid):
    n, s_max = edges.shape
    q = msg_lid.shape[0]
    dev = edges.device
    e_flat = edges.reshape(-1)
    e_idx = torch.arange(n * s_max, dtype=I32, device=dev)
    rows = torch.cat([torch.where(msg_valid, msg_lid, n).to(I32),
                      torch.where(e_flat >= 0, e_idx // s_max, n + 1)])
    vals = torch.cat([msg_gid.to(I32), e_flat.to(I32)])
    is_edge = torch.cat([torch.zeros(q, dtype=torch.bool, device=dev),
                         torch.ones(n * s_max, dtype=torch.bool, device=dev)])
    slot = torch.cat([torch.zeros(q, dtype=I32, device=dev), e_idx % s_max])
    order = lexsort((slot, is_edge.to(I32), vals, rows))
    del slot
    r_s, v_s, e_s = rows[order], vals[order], is_edge[order]
    del rows, vals, is_edge
    k = torch.arange(r_s.shape[0], device=dev)
    newgrp = (k == 0) | (r_s != torch.roll(r_s, 1)) | \
        (v_s != torch.roll(v_s, 1))
    del r_s, v_s
    start = torch.cummax(torch.where(newgrp, k, 0), dim=0).values
    del newgrp
    is_msg = (~e_s).to(I64)
    mcum = torch.cumsum(is_msg, dim=0)
    m_group = mcum - (mcum[start] - is_msg[start])
    del mcum, is_msg
    occ_rank = (k - start) - m_group
    kill_sorted = e_s & (occ_rank < m_group)
    del occ_rank, m_group, start, k
    kill = torch.empty(q + n * s_max, dtype=torch.bool, device=dev)
    kill[order] = kill_sorted
    return torch.where(kill[q:].reshape(n, s_max), -1, edges)


def cap_requests(cfg):
    n = cfg["neurons_per_rank"]
    per_dest = n * cfg["requests_cap_factor"]
    return min(n, max(32, -(-per_dest // 8) * 8))


def cap_deletions(cfg, lesions: bool):
    n = cfg["neurons_per_rank"]
    if not lesions:
        return max(16, n // 4)
    return min(n * cfg["max_synapses"],
               max(16, (n // 4) * cfg["requests_cap_factor"]))


def route_deletions(kill, edges, gids, cfg, lesions: bool):
    """The (partner gid, my gid) notifications of one rank, as the
    program's route buffers give them (one destination)."""
    n = cfg["neurons_per_rank"]
    flat_other = torch.where(kill, edges, -1).reshape(-1)
    flat_mine = torch.broadcast_to(gids[:, None], kill.shape).reshape(-1)
    cap = cap_deletions(cfg, lesions)
    valid = flat_other >= 0
    dest = torch.where(valid, torch.div(flat_other, n, rounding_mode="floor"),
                       1)
    slot = positions_within(dest, 2)
    ok = valid & (slot < cap)
    buf = torch.full((2, cap, 2), -1, dtype=I32, device=kill.device)
    buf[torch.where(ok, dest, 1).to(I64), torch.where(ok, slot, 0).to(I64)] = \
        torch.stack([torch.where(ok, flat_other, -1),
                     torch.where(ok, flat_mine, -1)], -1).to(I32)
    return buf[:1].reshape(-1, 2)


def drain(edges, msgs, n):
    return compact(remove_edges_by_messages(
        edges, torch.clamp(msgs[:, 0], 0, n - 1), msgs[:, 1],
        (msgs[:, 0] >= 0) & (msgs[:, 0] < n)))


# ------------------------------------------------------------------- tree
def _sum8(x):
    g = x.reshape(-1, 8, *x.shape[1:])
    acc = g[:, 0]
    for j in range(1, 8):
        acc = acc + g[:, j]
    return acc


def _leaf_sums(values, rel, slot, n_leaf: int):
    width = int(slot.max().item()) + 1 if slot.numel() else 1
    tbl = torch.zeros((n_leaf, width) + tuple(values.shape[1:]),
                      dtype=values.dtype, device=values.device)
    tbl[rel.to(I64), slot.to(I64)] = values
    acc = torch.zeros((n_leaf,) + tuple(values.shape[1:]), dtype=values.dtype,
                      device=values.device)
    for j in range(width):
        acc = acc + tbl[:, j]
    return acc


def build_tree(positions, weights, cfg):
    """The rank's octree (levels 0..local_levels) and leaf membership
    table, at rank 0 of one."""
    levels = cfg["local_levels"]
    n_leaf = 8 ** levels
    rel = torch.clamp(morton_encode(positions, levels), 0, n_leaf - 1)
    slot = positions_within(rel, n_leaf)
    counts_ = [_leaf_sums(weights, rel, slot, n_leaf)]
    cents = [_leaf_sums(positions * weights[:, None], rel, slot, n_leaf)]
    for _ in range(levels):
        counts_.insert(0, _sum8(counts_[0]))
        cents.insert(0, _sum8(cents[0]))
    m = cfg["leaf_members_cap"]
    ok = slot < m
    tbl = torch.full((n_leaf, m + 1), -1, dtype=I32, device=positions.device)
    tbl[rel.to(I64), torch.where(ok, slot, m).to(I64)] = torch.arange(
        positions.shape[0], dtype=I32, device=positions.device)
    return tuple(counts_), tuple(cents), tbl[:, :m].contiguous()


# -------------------------------------------------------- Barnes-Hut search
def _gauss(d2, sigma: float):
    s2 = torch.tensor(sigma * sigma, dtype=F32, device=d2.device)
    return torch.exp(-d2 / s2)


def pairwise_d2(x, y):
    x = x.to(F32)
    y = y.to(F32)
    xx = (x[:, 0] * x[:, 0] + x[:, 1] * x[:, 1] + x[:, 2] * x[:, 2])[:, None]
    yy = y[..., 0] * y[..., 0] + y[..., 1] * y[..., 1] + y[..., 2] * y[..., 2]
    xy = x[:, None, 0] * y[..., 0] + x[:, None, 1] * y[..., 1] \
        + x[:, None, 2] * y[..., 2]
    return torch.clamp_min(xx + yy - 2.0 * xy, 0.0)


def _level_size_at(sizes, lvl_rel):
    out = torch.full(lvl_rel.shape, sizes[0], dtype=F32,
                     device=lvl_rel.device)
    for k in range(1, len(sizes)):
        out = torch.where(lvl_rel == k, sizes[k], out)
    return out


def node_stats(counts_, cents, sizes, lvl_rel, cell, x, sigma):
    lvl = lvl_rel.to(I64)
    c = cell.to(I64)
    cnt = counts_[lvl, c]
    cent = cents[lvl, c]
    center = cent / torch.clamp_min(cnt, 1e-9)[..., None]
    d2 = pairwise_d2(x, center)
    size = _level_size_at(sizes, lvl_rel)
    crit = size / torch.sqrt(torch.clamp_min(d2, 1e-12))
    prob = cnt * _gauss(d2, sigma)
    return cnt, prob, crit


def _excl_cumsum(need):
    return torch.cumsum(need, dim=1) - need


def expand_and_sample(tree, x, root_cell, root_rel, src_gid, rnd, cfg,
                      chunk):
    counts_, cents, sizes = tree
    q = x.shape[0]
    f = cfg["frontier_cap"]
    n_levels = cfg["local_levels"] + 1
    theta, sigma = cfg["theta"], cfg["sigma"]
    last = n_levels - 1
    dev = x.device
    at_leaf = root_rel >= last
    child_rel = torch.where(at_leaf, root_rel, root_rel + 1)
    base8 = torch.where(at_leaf, root_cell, root_cell * 8)
    js = torch.arange(8, dtype=I32, device=dev)
    cells = torch.zeros((q, f), dtype=I32, device=dev)
    lvls = torch.zeros((q, f), dtype=I32, device=dev)
    valid = torch.zeros((q, f), dtype=torch.bool, device=dev)
    cells[:, :8] = base8[:, None] + torch.where(at_leaf[:, None], 0,
                                                js[None, :])
    lvls[:, :8] = child_rel[:, None]
    valid[:, :8] = torch.where(at_leaf[:, None], js[None] == 0, True)
    for _ in range(n_levels):
        cnt, prob, crit = node_stats(counts_, cents, sizes, lvls, cells, x,
                                     sigma)
        nonempty = cnt > 1e-9
        accepted = (crit < theta) | (lvls >= last)
        expand = valid & nonempty & ~accepted
        keepers = valid & ~expand & nonempty
        need = torch.where(expand, 8, torch.where(keepers, 1, 0))
        off = _excl_cumsum(need)
        fits = (off + need) <= f
        need2 = torch.where(expand & fits, 8, torch.where(
            keepers | (expand & ~fits), 1, 0))
        off2 = _excl_cumsum(need2)
        fits2 = (off2 + need2) <= f
        ncells = torch.zeros((q, f + 1), dtype=I32, device=dev)
        nlvls = torch.zeros((q, f + 1), dtype=I32, device=dev)
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
        cells, lvls, valid = ncells[:, :f], nlvls[:, :f], nvalid[:, :f]
    cnt, prob, _ = node_stats(counts_, cents, sizes, lvls, cells, x, sigma)
    logits = torch.where(valid & (cnt > 1e-9),
                         torch.log(torch.clamp_min(prob, 1e-30)),
                         torch.full_like(prob, NEG))
    g = gumbel(cfg["seed"], BH_DOMAIN,
               bh_ctr(chunk, rnd, torch.arange(f, device=dev))[None, :],
               src_gid[:, None], dev)
    pick = torch.argmax(logits + g, dim=1)
    qi = torch.arange(q, device=dev)
    any_valid = torch.any(logits > NEG / 2, dim=1)
    return cells[qi, pick], lvls[qi, pick], any_valid


def bh_search(tree, x, src_gid, start_cell, cfg, chunk):
    q = x.shape[0]
    dev = x.device
    n_levels = cfg["local_levels"] + 1
    last = n_levels - 1
    cell = start_cell.to(I32)
    rel = torch.zeros(q, dtype=I32, device=dev)
    valid = torch.ones(q, dtype=torch.bool, device=dev)
    done = torch.zeros(q, dtype=torch.bool, device=dev)
    for i in range(n_levels):
        ncell, nrel, nvalid = expand_and_sample(
            tree, x, cell, rel, src_gid, PHASE_B_ROUND_BASE + i, cfg, chunk)
        cell = torch.where(done, cell, ncell)
        rel = torch.where(done, rel, nrel)
        valid = torch.where(done, valid, nvalid)
        done = done | (rel >= last) | ~valid
    return cell, valid & (rel >= last)


def select_member(x, member_pos, member_weight, member_valid, src_gid, cfg,
                  chunk):
    m = member_pos.shape[1]
    d2 = pairwise_d2(x, member_pos)
    w = member_weight * _gauss(d2, cfg["sigma"])
    logits = torch.where(member_valid & (w > 1e-12),
                         torch.log(torch.clamp_min(w, 1e-30)),
                         torch.full_like(w, NEG))
    g = gumbel(cfg["seed"], BH_DOMAIN,
               bh_ctr(chunk, MEMBER_ROUND,
                      torch.arange(m, device=x.device))[None, :],
               src_gid[:, None], x.device)
    pick = torch.argmax(logits + g, dim=1)
    valid = torch.any(logits > NEG / 2, dim=1)
    return pick, valid


def stack_levels(counts_, cents, levels):
    lmax = max(c.shape[0] for c in counts_)
    cs = [torch.nn.functional.pad(c, (0, lmax - c.shape[0])) for c in counts_]
    zs = [torch.nn.functional.pad(z, (0, 0, 0, lmax - z.shape[0]))
          for z in cents]
    sizes = tuple(cell_size(k) for k in range(levels + 1))
    return torch.stack(cs), torch.stack(zs), sizes


def phase_b(tree, members, neuron_pos, vacant_d, x, start_cell, src_gid,
            valid_in, cfg, chunk):
    """Each query's search inside the rank's tree and its member pick:
    (target gid, ok), a block of queries at a time."""
    tgt, oks = [], []
    for lo in range(0, x.shape[0], QUERY_BLOCK):
        sl = slice(lo, lo + QUERY_BLOCK)
        leaf_cell, valid = bh_search(tree, x[sl], src_gid[sl],
                                     start_cell[sl], cfg, chunk)
        valid = valid & valid_in[sl]
        leaf = torch.clamp(leaf_cell.to(I64), 0, members.shape[0] - 1)
        mem = members[leaf]
        mvalid = mem >= 0
        msafe = torch.where(mvalid, mem, 0)
        mvalid = mvalid & (msafe != src_gid[sl, None])
        ms64 = msafe.to(I64)
        mw = torch.where(mvalid, vacant_d[ms64], 0.0)
        pick, pvalid = select_member(x[sl], neuron_pos[ms64], mw, mvalid,
                                     src_gid[sl], cfg, chunk)
        tgt_local = torch.gather(msafe, 1, pick[:, None])[:, 0]
        ok = valid & pvalid
        tgt.append(torch.where(ok, tgt_local, -1).to(I32))
        oks.append(ok)
    return torch.cat(tgt), torch.cat(oks)


# --------------------------------------------------- connectivity update
def _before_search(state, cfg, scenario):
    """The update up to the Barnes-Hut search: the lesion's elements, the
    retraction with its routed notifications and drains, the tree, and the
    query buffer as the owner rank receives it."""
    n = cfg["neurons_per_rank"]
    dev = state["in_edges"].device
    chunk = state["chunk"]
    chunk_key = fold_in_words(key_words(cfg["seed"] + 2), chunk)
    gids = torch.arange(n, dtype=I32, device=dev)
    pos = state["positions"]
    ax, de = state["ax_elements"], state["de_elements"]
    alive = alive_mask(scenario, pos, (chunk + 1) * cfg["rate_period"])
    if alive is not None:
        ax = torch.where(alive, ax, 0.0)
        de = torch.where(alive, de, 0.0)
    k_out, k_in, k_accept = split_words(chunk_key, 3)
    # retraction, routed notifications and their drains
    out0, in0 = state["out_edges"], state["in_edges"]
    del_out = torch.clamp_min(counts(out0) - torch.floor(ax).to(I32), 0)
    del_in = torch.clamp_min(counts(in0) - torch.floor(de).to(I32), 0)
    out1, kill_out = retract_synapses(k_out, out0, del_out, gids)
    in1, kill_in = retract_synapses(k_in, in0, del_in, gids)
    lesions = bool(_lesion_windows(scenario)) if scenario else False
    msgs_out = route_deletions(kill_out, out0, gids, cfg, lesions)
    msgs_in = route_deletions(kill_in, in0, gids, cfg, lesions)
    del kill_out, kill_in
    in_edges = drain(in1, msgs_out, n)
    del in1
    out_edges = drain(out1, msgs_in, n)
    del out1
    # the tree and the requests (at one rank all go to rank 0)
    vac_a = torch.floor(ax).to(I32) - counts(out_edges)
    vac_d_pos = torch.clamp_min(de - counts(in_edges).to(F32), 0.0)
    t_counts, t_cents, members = build_tree(pos, vac_d_pos, cfg)
    searching = vac_a >= 1
    if alive is not None:
        searching = searching & alive
        vac_d_pos = torch.where(alive, vac_d_pos, 0.0)
    valid_a = searching
    cap = cap_requests(cfg)
    dest = torch.where(valid_a, 0, 1)
    slot = positions_within(dest, 2)
    ok = valid_a & (slot < cap)
    ibuf = torch.full((2, cap, 2), -1, dtype=I32, device=dev)
    fbuf = torch.zeros((2, cap, 3), dtype=F32, device=dev)
    d_c = torch.where(ok, dest, 1).to(I64)
    s_c = torch.where(ok, slot, 0).to(I64)
    ibuf[d_c, s_c] = torch.stack([torch.where(ok, gids, -1),
                                  torch.zeros_like(gids)], -1).to(I32)
    fbuf[d_c, s_c] = pos
    r_src = ibuf[:1, :, 0].reshape(-1)
    r_valid = r_src >= 0
    return {"ax": ax, "de": de, "alive": alive, "in_edges": in_edges,
            "out_edges": out_edges, "vac_d_pos": vac_d_pos,
            "tree": stack_levels(t_counts, t_cents, cfg["local_levels"]),
            "widths": tuple(c.shape[0] for c in t_counts),
            "members": members, "r_src": r_src, "r_valid": r_valid,
            "r_pos": fbuf[:1].reshape(-1, 3),
            "start": torch.clamp_min(ibuf[:1, :, 1].reshape(-1), 0),
            "src": torch.where(r_valid, r_src, -2), "ok": ok, "d_c": d_c,
            "s_c": s_c, "cap": cap, "k_accept": k_accept}


def connectivity_update(state, table, cfg, scenario):
    n = cfg["neurons_per_rank"]
    dev = state["in_edges"].device
    chunk = state["chunk"]
    p = _before_search(state, cfg, scenario)
    tgt, bvalid = phase_b(p["tree"], p["members"], state["positions"],
                          p["vac_d_pos"], p["r_pos"], p["start"], p["src"],
                          p["r_valid"], cfg, chunk)
    acc, in_edges = accept_requests(
        torch.clamp(tgt, 0, n - 1), p["r_src"], bvalid & (tgt >= 0),
        p["vac_d_pos"], p["in_edges"], key_tensor(p["k_accept"], dev))
    rbuf = torch.stack([torch.where(acc, tgt, -1), acc.to(I32)],
                       -1).reshape(1, p["cap"], 2)
    d_g = torch.clamp(p["d_c"], max=0)
    resp_tgt = rbuf[d_g, p["s_c"], 0]
    resp_ok = (rbuf[d_g, p["s_c"], 1] > 0) & p["ok"]
    out_edges = add_out_edges(p["out_edges"], resp_tgt, resp_ok)
    # rate refresh and the (one-rank) dense exchange
    rate = state["spike_count"] / float(cfg["rate_period"])
    if p["alive"] is not None:
        rate = torch.where(p["alive"], rate, 0.0)
    out = dict(state)
    out.update(ax_elements=p["ax"], de_elements=p["de"], out_edges=out_edges,
               in_edges=in_edges, rate=rate,
               spike_count=torch.zeros_like(state["spike_count"]),
               rates_table=rate[None], chunk=chunk + 1)
    return out


def search_inputs(state, cfg, scenario=None):
    """The inputs of the chunk's Barnes-Hut search (K2's), recomputed from
    the state before the chunk: the activity window, then the update up to
    the search."""
    table = population_table(cfg, cfg["neurons_per_rank"],
                             state["v"].device)
    state = activity_window(state, table, cfg, scenario)
    p = _before_search(state, cfg, scenario)
    p["positions"] = state["positions"]
    return p


def chunk(state, cfg, scenario=None, precision="float32"):
    """One chunk: Delta activity steps and one connectivity update."""
    table = population_table(cfg, cfg["neurons_per_rank"],
                             state["v"].device)
    state = activity_window(state, table, cfg, scenario, precision)
    return connectivity_update(state, table, cfg, scenario)


# ------------------------------------------------------------- recorder
def record_row(state, cfg, scenario, bins: int = 16,
               rate_hist_max: float = 0.5):
    """One row of the program's per-region recorder
    (``scenarios/observables.py::record``) for a state whose chunk has
    just ended: {calcium, rate, synapses, alive, connectome, rate_hist}."""
    regions = scenario["regions"] if scenario else []
    nb = len(regions) + 1
    pos = state["positions"]
    rid = assign_regions(pos, regions)
    alive = alive_mask(scenario, pos, state["chunk"] * cfg["rate_period"])

    def count(index, size):
        return torch.zeros(size, dtype=I64, device=index.device).index_add_(
            0, index.reshape(-1).to(I64), torch.ones(
                index.numel(), dtype=I64, device=index.device))

    def mean(values):
        sums = torch.stack([torch.sum(torch.where(rid == b, values, 0.0))
                            for b in range(nb)])
        return sums / torch.clamp_min(count(rid, nb).to(I32).to(F32), 1.0)

    alive_rid = rid if alive is None else torch.where(alive, rid, nb)
    n_alive = count(alive_rid, nb + 1).to(I32)[:nb]
    out_edges = state["out_edges"]
    valid = out_edges >= 0
    safe = torch.clamp(out_edges, 0, rid.shape[0] - 1).to(I64)
    tgt_r = rid[safe].to(I64)
    src_r = torch.broadcast_to(rid[:, None].to(I64), out_edges.shape)
    cell = torch.where(valid, src_r * nb + tgt_r, nb * nb)
    conn = count(cell, nb * nb + 1).to(I32)[:nb * nb].reshape(nb, nb).to(F32)
    rate = state["rate"]
    bin_of = torch.clamp((rate / rate_hist_max * bins).to(I32), 0, bins - 1)
    return {"calcium": mean(state["calcium"]), "rate": mean(rate),
            "synapses": torch.sum(conn, dim=1), "alive": n_alive.to(F32),
            "connectome": conn,
            "rate_hist": count(bin_of, bins).to(I32).to(F32)}


# ------------------------------------------------------------- comparison
def mismatches(a, b) -> int:
    """Elements whose bits differ between two tensors of one shape (a
    shape that differs counts every element)."""
    if a.shape != b.shape:
        return max(a.numel(), b.numel())
    if a.dtype.is_floating_point:
        a = a.contiguous().view(torch.int32 if a.element_size() == 4
                                else torch.int16)
        b = b.to(a.device).contiguous().view(a.dtype)
    return int((a != b.to(a.device)).sum())


def state_mismatches(got: dict, want: dict) -> dict:
    return {k: mismatches(got[k], want[k]) for k in STATE_FIELDS}
