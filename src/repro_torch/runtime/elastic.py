"""Elastic resume of a brain checkpoint on fewer ranks: the port's copy of
the brain half of the JAX package's ``repro/runtime/elastic.py``.

Checkpoints hold full logical arrays in gid order (``checkpoint.manager``),
so a new rank count is a question of which rows each rank takes and of the
rank-local exchange state, which is derived again rather than resharded.
"""
from __future__ import annotations

import numpy as np

from repro_torch.checkpoint import manager


def _latest_valid(ckpt_dir: str):
    """Newest step whose arrays pass verification, with its contents."""
    for step in reversed(manager.steps_available(ckpt_dir)):
        try:
            arrays, manifest = manager.load_arrays(ckpt_dir, step)
        except manager.CorruptCheckpointError:
            continue
        return step, arrays, manifest
    raise FileNotFoundError(f"no valid brain checkpoint in {ckpt_dir}")


def _collapse_ranks(key: str, arr: np.ndarray, r_old: int,
                    r_new: int) -> np.ndarray:
    """Fold a per-rank (R_old, ...) metrics leaf down to (R_new, ...):
    counters, rings and histograms sum within each merged rank group (the
    global sums, the conservation check's inputs among them, are kept);
    the psum'd ``health_flags`` gauge is a replicated bitmask and folds by
    max."""
    grouped = arr.reshape(r_new, r_old // r_new, *arr.shape[1:])
    if key.endswith("health_flags"):
        return np.asarray(grouped.max(axis=1))
    return np.asarray(grouped.sum(axis=1))


def remesh_restore_brain(ckpt_dir: str, cfg, num_ranks: int = 1, step=None,
                         scenario=None, device=None, comm=None):
    """Restore a brain checkpoint onto a ``Simulator(cfg, scenario,
    num_ranks, device, comm)``, whose rank count or exchange layout may
    differ from the writer's. Returns ``(sim, step)``; the latest valid
    step when ``step`` is None.

    Why this works: ``gid == global row`` holds for every rank count (gid =
    rank * n + lid, ranks owning consecutive rows), so the per-neuron
    state, the positions and the gid-valued edge tables pass through
    unchanged. When ``R_new`` divides ``R_old``, the Morton decomposition
    of the new rank count gives each merged rank group the union of its old
    ranks' cell spans, so every neuron stays inside its owner's subdomain,
    which the octree build needs. Growing the rank count would split ranks
    whose neurons are not Morton-sorted, so it is refused.

    The dense (R, n) table is the gathered rate vector reshaped; the sparse
    registry, slot remap and rate buffer are rebuilt by
    ``Simulator.rebuild_exchange``, the computation every chunk's exchange
    runs, hence bitwise equal at a chunk boundary. Metrics leaves fold per
    merged rank group (sum; ``health_flags`` by max). Under a process group
    every process reads the arrays and keeps its own rows."""
    from repro_torch.core import spikes
    from repro_torch.sim.api import Simulator

    if step is None:
        step, arrays, manifest = _latest_valid(ckpt_dir)
    else:
        arrays, manifest = manager.load_arrays(ckpt_dir, step)
    meta = manifest.get("metadata", {})

    sim = Simulator(cfg, scenario=scenario, num_ranks=num_ranks,
                    device=device, comm=comm)
    r_new, n_new = sim.num_ranks, cfg.neurons_per_rank
    n_total = arrays[".positions"].shape[0]
    r_old = int(meta.get("num_ranks",
                         n_total // int(meta.get("neurons_per_rank", n_new))))
    if r_new * n_new != n_total:
        raise ValueError(
            f"checkpoint holds {n_total} neurons; cfg gives "
            f"{r_new} ranks x {n_new} = {r_new * n_new}")
    if r_old % r_new != 0:
        raise ValueError(
            f"elastic brain resume requires the new rank count to divide "
            f"the old ({r_old} -> {r_new}): growing splits ranks whose "
            f"neurons are not Morton-sorted")

    target = sim._template()
    out = []
    for key, leaf in manager._flatten(target):
        shape = () if isinstance(leaf, int) else tuple(leaf.shape)
        if key == ".rates_table":
            if key in arrays:                       # dense -> dense
                arr = arrays[key].reshape(shape)
            else:                                   # sparse -> dense
                arr = arrays[".neurons/.rate"].reshape(shape)
        elif key == ".subs":
            arr = np.full(shape, int(spikes.NO_SUB), np.int32)
        elif key == ".rate_slots":
            arr = np.full(shape, -1, np.int32)
        elif key == ".remote_rates":
            arr = np.zeros(shape, np.float32)
        elif key.startswith(".stats/"):
            arr = _collapse_ranks(key, arrays[key], r_old, r_new)
        else:
            arr = arrays.get(key)
            if arr is None:
                raise KeyError(f"checkpoint missing leaf {key!r}")
            if tuple(arr.shape) != shape:
                raise ValueError(f"{key}: shape {arr.shape} != {shape}")
        out.append(manager.as_leaf(arr, leaf, str(arr.dtype)))
    sim._install(manager._unflatten(target, out))
    # the sparse registry for THIS rank count (no-op for dense)
    sim.rebuild_exchange()
    sim.lifecycle.update({k: int(v) for k, v in
                          meta.get("lifecycle", {}).items()})
    sim.lifecycle["checkpoint_restores"] += 1
    return sim, step
