"""Retraction and the synapse priorities on the card (registry domain
"apply", ``apply_impl="fused"``): the wrappers of ``csrc/retract.cu``.

Not a TPU kernel: the JAX package computes retraction and the priorities in
jnp (``repro/connectome/synapses.py``). Plain versions:
``connectome/synapses.py::retract_synapses`` and ``edge_priority``, which
draw jax.random's priorities through ``prng`` (three launches of K0's draw
kernel on the card, the int64 Threefry of ``kernels/hash.py`` on the CPU);
the kernels draw the same bits from K0's device function
(``csrc/hash.cuh``) in registers and are bit-equal.

``retract`` and ``edge_priority`` take the key as two u32 words by value
(``prng.key_words`` / ``fold_in_words`` / ``split_words``), so a call copies
no scalar to the card; a (2,) key tensor is read back to the host first. On
CUDA tensors they launch the kernel or raise; on CPU tensors they run the
plain versions.
"""
from __future__ import annotations

import torch

from repro_torch import prng
from repro_torch.connectome import synapses as syn
from repro_torch.kernels import _build

MAX_SLOTS = 32        # a row is one warp, a slot one lane

retract_launches = _build.LaunchCounter("retract")
priority_launches = _build.LaunchCounter("edge_priority")


def retract(key, edges, n_delete, row_gids):
    """Break the ``n_delete[i]`` lowest-priority occupied slots of each row
    i of ``edges`` (n, S) int32, priorities keyed by (``row_gids[i]``,
    partner). Returns (new_edges (n, S) int32, kill (n, S) bool), as
    ``retract_synapses``."""
    if edges.device.type != "cuda":
        return syn.retract_synapses(key, edges, n_delete, row_gids)
    n, s_max = edges.shape
    if not 1 <= s_max <= MAX_SLOTS:
        raise ValueError(f"retract: 1 to {MAX_SLOTS} slots a row, got "
                         f"{s_max}")
    i32 = torch.int32
    tbl = edges.to(i32).contiguous()
    nd = n_delete.to(i32).contiguous()
    gid = row_gids.to(i32).contiguous()
    out = torch.empty_like(tbl)
    kill = torch.empty((n, s_max), dtype=torch.bool, device=tbl.device)
    _build.require_cuda("retract", tbl, nd, gid, out, kill)
    if nd.shape != (n,) or gid.shape != (n,):
        raise ValueError("retract: n_delete and row_gids need one entry a "
                         "row")
    k0, k1 = prng.as_words(key)
    _build.check(_build.library().repro_retract(
        tbl.data_ptr(), nd.data_ptr(), gid.data_ptr(), out.data_ptr(),
        kill.data_ptr(), n, s_max, k0, k1, _build.stream()), "retract")
    retract_launches.add()
    return out, kill


def edge_priority(key, a_gid, b_gid, valid=None):
    """``uniform(fold_in(fold_in(key, a), b))`` for every pair (Q,) f32;
    where ``valid`` is given and false, the pair (0, 0) is drawn instead, as
    ``synapses.request_priority`` draws it."""
    if a_gid.device.type != "cuda":
        if valid is None:
            return syn.edge_priority(key, a_gid, b_gid)
        return syn.request_priority(key, b_gid, a_gid, valid)
    i32 = torch.int32
    a = a_gid.to(i32).contiguous()
    b = b_gid.to(i32).contiguous()
    v = None if valid is None else valid.to(torch.bool).contiguous()
    q = a.shape[0]
    out = torch.empty(q, dtype=torch.float32, device=a.device)
    _build.require_cuda("edge_priority", a, b, out,
                        *(() if v is None else (v,)))
    if a.dim() != 1 or b.shape != (q,) or (v is not None and
                                           v.shape != (q,)):
        raise ValueError("edge_priority: a, b (and valid) must be (Q,)")
    k0, k1 = prng.as_words(key)
    _build.check(_build.library().repro_edge_priority(
        a.data_ptr(), b.data_ptr(), None if v is None else v.data_ptr(),
        out.data_ptr(), q, k0, k1, _build.stream()), "edge_priority")
    priority_launches.add()
    return out
