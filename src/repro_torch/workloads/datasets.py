"""Connectome datasets: the versioned on-disk format, the deterministic
hemibrain-shaped surrogate generator, and the edge-list -> synapse-table
builder behind ``Simulator.from_connectome``.

The port's own copy of the JAX package's ``repro/workloads/datasets.py``
(numpy only): the same format, the same PCG64 stream (the generator's output
is bit-equal to the reference's), the same checks and messages.
``regions()`` gives the port's ``scenarios.regions.Region`` and
``check_population_layout`` reads the port's population table.

On-disk format (``repro.connectome/v1``, one compressed npz)::

    format_version  ()        int   — 1
    name            ()        str
    positions       (N, 3)    f32   — unit cube [0, 1)^3, row == gid
    edges           (E, 2)    i32   — (pre_gid, post_gid), sorted by
                                      (pre, post); multi-edges allowed,
                                      self-loops not
    edge_types      (E,)      i32   — 0 excitatory / 1 inhibitory (the
                                      pre-neuron's sign)
    region_ids      (N,)      i32   — region label per neuron
    region_names    (nr,)     str
    region_boxes    (nr, 2, 3) f32  — axis-aligned [lo, hi) per region
    is_excitatory   (N,)      bool

The canonical invariant is **gid == global row**: rank ``r`` of an
``R``-rank simulation with ``n = N / R`` neurons per rank owns rows
``[r*n, (r+1)*n)``. The generator emits rows in Morton order so those
blocks are spatially coherent (the octree build tolerates — clips — the
stragglers near block boundaries), and assigns excitation periodically
within each ``block`` of rows (first ``int(block * fraction_excitatory)``
rows excitatory) so the dataset matches the population table every rank
derives from ``(cfg, scenario, n)`` — the replicated-derivation invariant
that lets any rank look up a synapse weight from ``gid % n``
(``check_population_layout`` enforces this at load time).

The surrogate is hemibrain *shaped*, not hemibrain data: log-normal
out-degrees (heavy tail), spatially clustered regions of uneven size
(Dirichlet weights over the Morton octants), distance-biased targets
(``p_local`` of each neuron's synapses stay in-region). Scaled up it
reaches the Drosophila-hemibrain envelope simulated on Loihi 2
(arXiv:2508.16792): ``generate_hemibrain_surrogate(139_264, block=...,
avg_degree=390)`` ≈ 139k neurons / 54M synapses — while CI runs the same
generator at smoke scale with no download.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import numpy as np

FORMAT_VERSION = 1
FORMAT = "repro.connectome/v1"

_MORTON_LEVEL = 9   # canonical-order resolution (matches core.morton cap)


class ConnectomeDataset(NamedTuple):
    """An immutable host-side connectome (see module docstring for the
    field contracts). All arrays are plain numpy."""
    name: str
    positions: np.ndarray       # (N, 3) f32
    edges: np.ndarray           # (E, 2) i32 (pre, post)
    edge_types: np.ndarray      # (E,) i32
    region_ids: np.ndarray      # (N,) i32
    region_names: Tuple[str, ...]
    region_boxes: np.ndarray    # (nr, 2, 3) f32
    is_excitatory: np.ndarray   # (N,) bool

    @property
    def num_neurons(self) -> int:
        return int(self.positions.shape[0])

    @property
    def num_edges(self) -> int:
        return int(self.edges.shape[0])

    def out_degrees(self) -> np.ndarray:
        return np.bincount(self.edges[:, 0], minlength=self.num_neurons)

    def in_degrees(self) -> np.ndarray:
        return np.bincount(self.edges[:, 1], minlength=self.num_neurons)

    def regions(self):
        """The dataset's regions as scenario ``Region`` boxes, usable
        directly in protocols / ``assign_regions`` (same geometry the
        region_ids were assigned from)."""
        from repro_torch.scenarios.regions import Region
        return tuple(
            Region(name, lo=tuple(float(x) for x in box[0]),
                   hi=tuple(float(x) for x in box[1]))
            for name, box in zip(self.region_names, self.region_boxes))


# ================================================================ save/load
def save(path: str, ds: ConnectomeDataset) -> None:
    """Write ``ds`` to one compressed npz (format-versioned)."""
    validate(ds)
    np.savez_compressed(
        path, format_version=np.int64(FORMAT_VERSION), name=str(ds.name),
        positions=ds.positions.astype(np.float32),
        edges=ds.edges.astype(np.int32),
        edge_types=ds.edge_types.astype(np.int32),
        region_ids=ds.region_ids.astype(np.int32),
        region_names=np.asarray(ds.region_names),
        region_boxes=ds.region_boxes.astype(np.float32),
        is_excitatory=ds.is_excitatory.astype(bool))


def load(path: str) -> ConnectomeDataset:
    """Read and validate a ``repro.connectome/v1`` npz."""
    with np.load(path, allow_pickle=False) as z:
        version = int(z["format_version"])
        if version != FORMAT_VERSION:
            raise ValueError(
                f"{path}: connectome format_version {version}, "
                f"this build reads {FORMAT_VERSION} ({FORMAT})")
        ds = ConnectomeDataset(
            name=str(z["name"]),
            positions=np.asarray(z["positions"], np.float32),
            edges=np.asarray(z["edges"], np.int32),
            edge_types=np.asarray(z["edge_types"], np.int32),
            region_ids=np.asarray(z["region_ids"], np.int32),
            region_names=tuple(str(s) for s in z["region_names"]),
            region_boxes=np.asarray(z["region_boxes"], np.float32),
            is_excitatory=np.asarray(z["is_excitatory"], bool))
    validate(ds)
    return ds


def validate(ds: ConnectomeDataset) -> None:
    """Structural invariants every dataset must hold (gid == row, positions
    in the unit cube, edges in range, no self-loops, typed by source)."""
    N, E = ds.num_neurons, ds.num_edges
    if ds.positions.shape != (N, 3):
        raise ValueError(f"positions shape {ds.positions.shape} != ({N}, 3)")
    if not (np.isfinite(ds.positions).all() and ds.positions.min() >= 0.0
            and ds.positions.max() < 1.0):
        raise ValueError("positions must be finite and inside [0, 1)^3")
    if ds.edges.shape != (E, 2) or ds.edge_types.shape != (E,):
        raise ValueError("edges must be (E, 2) with (E,) edge_types")
    if E and (ds.edges.min() < 0 or ds.edges.max() >= N):
        raise ValueError("edge gids out of range [0, N)")
    if E and (ds.edges[:, 0] == ds.edges[:, 1]).any():
        raise ValueError("self-loop edges are not allowed")
    if ds.region_ids.shape != (N,):
        raise ValueError("region_ids must be (N,)")
    nr = len(ds.region_names)
    if ds.region_boxes.shape != (nr, 2, 3):
        raise ValueError("region_boxes must be (len(region_names), 2, 3)")
    if nr and ds.region_ids.size and \
            (ds.region_ids.min() < 0 or ds.region_ids.max() >= nr):
        raise ValueError("region_ids out of range")
    if ds.is_excitatory.shape != (N,):
        raise ValueError("is_excitatory must be (N,)")
    if E and not np.array_equal(
            ds.edge_types, (~ds.is_excitatory[ds.edges[:, 0]]).astype(
                np.int32)):
        raise ValueError("edge_types must be the pre-neuron's sign "
                         "(0 excitatory / 1 inhibitory)")


def check_population_layout(ds: ConnectomeDataset, cfg, scenario,
                            num_ranks: int) -> None:
    """The weight-sign replicated-derivation invariant: every rank derives
    one (n,) population table from (cfg, scenario) and reads any neuron's
    synapse weight at ``gid % n`` — so the dataset's per-neuron excitation
    must equal that table on EVERY rank block. (Arbitrary per-neuron signs
    need a global (N,) weight table threaded through both activity
    lowerings; the JAX package has none either.)"""
    from repro_torch.scenarios import populations as pops
    n = cfg.neurons_per_rank
    table = pops.table_for(cfg, scenario, n,
                           device="cpu").is_excitatory.numpy()
    got = ds.is_excitatory.reshape(num_ranks, n)
    bad = np.nonzero((got != table[None, :]).any(axis=1))[0]
    if bad.size:
        raise ValueError(
            f"dataset excitation layout does not match the population table "
            f"on rank block(s) {bad.tolist()[:4]}: each block of "
            f"{n} rows must put its excitatory neurons exactly where the "
            f"(cfg, scenario) population table does (generator: pass "
            f"block={n} and matching fraction_excitatory)")


# ================================================================ morton
def _np_part1by2(x: np.ndarray) -> np.ndarray:
    x = x.astype(np.uint32) & np.uint32(0x3FF)
    x = (x | (x << 16)) & np.uint32(0x030000FF)
    x = (x | (x << 8)) & np.uint32(0x0300F00F)
    x = (x | (x << 4)) & np.uint32(0x030C30C3)
    x = (x | (x << 2)) & np.uint32(0x09249249)
    return x


def _np_compact1by2(x: np.ndarray) -> np.ndarray:
    x = x.astype(np.uint32) & np.uint32(0x09249249)
    x = (x ^ (x >> 2)) & np.uint32(0x030C30C3)
    x = (x ^ (x >> 4)) & np.uint32(0x0300F00F)
    x = (x ^ (x >> 8)) & np.uint32(0x030000FF)
    x = (x ^ (x >> 16)) & np.uint32(0x000003FF)
    return x


def morton_codes(pos: np.ndarray, level: int) -> np.ndarray:
    """Host-side Morton codes, bit-compatible with ``core.morton``."""
    g = 1 << level
    ijk = np.clip((pos * g).astype(np.int64), 0, g - 1).astype(np.uint32)
    code = (_np_part1by2(ijk[:, 0]) | (_np_part1by2(ijk[:, 1]) << 1)
            | (_np_part1by2(ijk[:, 2]) << 2))
    return code.astype(np.int64)


def _cell_boxes(level: int) -> np.ndarray:
    """(8^level, 2, 3) [lo, hi) box per Morton cell at ``level``."""
    cells = np.arange(8 ** level, dtype=np.uint32)
    ijk = np.stack([_np_compact1by2(cells), _np_compact1by2(cells >> 1),
                    _np_compact1by2(cells >> 2)], axis=-1)
    size = 1.0 / (1 << level)
    lo = ijk.astype(np.float32) * size
    return np.stack([lo, lo + np.float32(size)], axis=1)


# ================================================================ generator
def generate_hemibrain_surrogate(
        num_neurons: int, block: int, *, avg_degree: float = 8.0,
        max_degree: int = 16, seed: int = 0,
        fraction_excitatory: float = 0.8, region_level: int = 1,
        degree_sigma: float = 1.0, p_local: float = 0.7,
        cluster: float = 0.35, name: str = "hemibrain-surrogate",
) -> ConnectomeDataset:
    """Deterministic hemibrain-shaped surrogate (see module docstring).

    ``block`` must match the intended ``cfg.neurons_per_rank`` (excitation
    is laid out periodically per block) and ``fraction_excitatory`` the
    intended config's. ``max_degree`` caps BOTH out- and in-degree — set it
    to the intended ``cfg.max_synapses`` so the edge tables fit. Regions
    are the ``8^region_level`` Morton cells of the unit cube with Dirichlet
    -weighted (uneven) neuron counts; neurons cluster around their region
    center (``cluster`` in cell-size units). Same arguments -> bit-equal
    dataset, on any machine (single fixed PCG64 stream).
    """
    if num_neurons % block:
        raise ValueError(f"num_neurons={num_neurons} not a multiple of "
                         f"block={block}")
    if max_degree < 1:
        raise ValueError("max_degree must be >= 1")
    rng = np.random.default_rng(seed)
    N = num_neurons
    nr = 8 ** region_level
    boxes = _cell_boxes(region_level)
    names = tuple(f"m{region_level}c{i:02d}" for i in range(nr))

    # --- spatially clustered regions of uneven size -------------------
    weights = rng.dirichlet(np.full(nr, 1.5))
    region_of = rng.choice(nr, size=N, p=weights).astype(np.int32)
    size = 1.0 / (1 << region_level)
    center = (boxes[region_of, 0] + boxes[region_of, 1]) * 0.5
    off = np.clip(rng.normal(0.0, cluster * size, (N, 3)),
                  -0.5 * size + 1e-6, 0.5 * size - 1e-6)
    pos = np.clip(center + off, 0.0, 1.0 - 1e-6).astype(np.float32)

    # --- canonical order: global Morton sort (gid == row, rank blocks
    # spatially coherent; region cells are Morton-aligned, so each
    # region's rows come out contiguous) ------------------------------
    order = np.argsort(morton_codes(pos, _MORTON_LEVEL), kind="stable")
    pos, region_of = pos[order], region_of[order]
    is_exc = (np.arange(N) % block) < int(block * fraction_excitatory)

    # --- log-normal out-degrees (heavy tail), distance-biased targets -
    mu = math.log(max(avg_degree, 1e-6)) - 0.5 * degree_sigma ** 2
    deg = np.clip(np.rint(rng.lognormal(mu, degree_sigma, N)),
                  0, max_degree).astype(np.int64)
    src = np.repeat(np.arange(N, dtype=np.int64), deg)
    start = np.searchsorted(region_of, np.arange(nr))
    count = np.bincount(region_of, minlength=nr)
    rsrc = region_of[src]
    local = (rng.random(src.size) < p_local) & (count[rsrc] > 1)
    tgt_local = start[rsrc] + rng.integers(
        0, np.maximum(count[rsrc], 1), size=src.size)
    tgt_global = rng.integers(0, N, size=src.size)
    tgt = np.where(local, tgt_local, tgt_global)
    keep = tgt != src                                    # no self-loops
    src, tgt = src[keep], tgt[keep]

    # --- deterministic in-degree cap: keep each target's first
    # ``max_degree`` in-edges in (pre, post) order --------------------
    order = np.lexsort((tgt, src))
    src, tgt = src[order], tgt[order]
    o2 = np.argsort(tgt, kind="stable")
    rank_in_tgt = np.arange(tgt.size) - np.searchsorted(tgt[o2], tgt[o2])
    keep = np.zeros(tgt.size, bool)
    keep[o2] = rank_in_tgt < max_degree
    src, tgt = src[keep], tgt[keep]

    edges = np.stack([src, tgt], axis=1).astype(np.int32)
    ds = ConnectomeDataset(
        name=name, positions=pos, edges=edges,
        edge_types=(~is_exc[src]).astype(np.int32),
        region_ids=region_of.astype(np.int32), region_names=names,
        region_boxes=boxes.astype(np.float32),
        is_excitatory=is_exc)
    validate(ds)
    return ds


# ================================================================ tables
def edge_tables(ds: ConnectomeDataset, s_max: int):
    """Global front-packed synapse tables from the edge list: ``(out_edges
    (N, s_max) target gids, in_edges (N, s_max) source gids)``, -1 empty.
    Rows are compacted (occupied slots first) — the layout every table op
    (``accept_requests`` in particular) assumes — and slot order is the
    canonical (pre, post) edge order, so save -> load -> rebuild is
    bit-stable. Raises if any degree exceeds ``s_max``."""
    N = ds.num_neurons
    src, tgt = ds.edges[:, 0].astype(np.int64), ds.edges[:, 1].astype(
        np.int64)
    order = np.lexsort((tgt, src))
    src, tgt = src[order], tgt[order]
    for what, deg in (("out", np.bincount(src, minlength=N)),
                      ("in", np.bincount(tgt, minlength=N))):
        mx = int(deg.max()) if deg.size else 0
        if mx > s_max:
            raise ValueError(
                f"dataset {ds.name!r}: max {what}-degree {mx} exceeds "
                f"max_synapses={s_max} — raise cfg.max_synapses or "
                f"regenerate with max_degree<={s_max}")
    out_edges = np.full((N, s_max), -1, np.int32)
    slot = np.arange(src.size) - np.searchsorted(src, src)
    out_edges[src, slot] = tgt
    o2 = np.argsort(tgt, kind="stable")
    s2, t2 = src[o2], tgt[o2]
    in_edges = np.full((N, s_max), -1, np.int32)
    slot2 = np.arange(t2.size) - np.searchsorted(t2, t2)
    in_edges[t2, slot2] = s2
    return out_edges, in_edges


def max_unique_remote_sources(ds: ConnectomeDataset, n: int) -> int:
    """max over ranks of |unique remote source gids in the rank's in-edge
    table| — the measured quantity ``cap_subs`` sizes the subscription
    registry from (``cfg.subs_cap_base``)."""
    src, tgt = ds.edges[:, 0].astype(np.int64), ds.edges[:, 1].astype(
        np.int64)
    post_rank = tgt // n
    remote = post_rank != (src // n)
    if not remote.any():
        return 0
    pairs = np.unique(np.stack([post_rank[remote], src[remote]], 1), axis=0)
    counts = np.bincount(pairs[:, 0], minlength=ds.num_neurons // n)
    return int(counts.max())
