"""K4, the synapse-table apply, and K5, the deletion-routing buffer build
(registry domain "apply", ``apply_impl="fused"``).

Plain versions: ``synapse_apply_plain`` is the composition the JAX package's
kernel runs, ``remove_edges_by_messages`` -> ``compact`` -> ``accept_core``
(``connectome/synapses.py``); ``route_build_plain`` is
``routing.route_build_core`` with ``bucket_ranks`` as the ranker. Either
stage of ``synapse_apply`` is disabled by passing no valid messages or no
valid requests: the other stage then leaves the (compacted) table as it is.

``synapse_apply`` and ``route_build`` are the wrappers of the hand-written
CUDA kernels in ``csrc/synapse_apply.cu`` (each one cooperative launch a
call): on CUDA tensors they launch the kernel or raise;
on CPU tensors they run the plain versions. Priorities are
computed outside the kernels, by the caller, with the same expression the
reference uses.

Preconditions of the kernels (the callers in ``connectome/`` meet them):
valid messages and requests name a row in [0, n); partner gids in the
routing input are below ``num_ranks * n``; S <= 32.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.connectome import routing
from repro_torch.connectome import synapses as syn
from repro_torch.kernels import _build
from repro_torch.kernels.radix_sort import bucket_ranks

MAX_RANKS = 64        # destination buckets the routing kernel holds
MAX_SLOTS = 2 ** 31 - 1   # num_ranks * cap: a slot's index is an int32

apply_launches = _build.LaunchCounter("synapse_apply")
route_launches = _build.LaunchCounter("route_build")


def device_launches(*, reset: bool = False) -> int:
    """K4's device launches since the last reset, as counted in
    ``csrc/synapse_apply.cu`` beside each launch; ``reset`` sets the count to
    0 after reading it."""
    return int(_build.library().repro_synapse_apply_device_launches(
        int(reset)))


def route_device_launches(*, reset: bool = False) -> int:
    """K5's device launches since the last reset, as counted in
    ``csrc/synapse_apply.cu`` beside the launch (one a call); ``reset`` sets
    the count to 0 after reading it."""
    return int(_build.library().repro_route_build_device_launches(
        int(reset)))


@functools.lru_cache(maxsize=64)
def _route_workspace(device_index: int, m: int, num_ranks: int) -> int:
    """int32 words of scratch a call of K5 takes on the device (its grid x
    num_ranks counts)."""
    del device_index    # a key only: the C entry reads the current device
    return int(_build.library().repro_route_build_workspace(m, num_ranks))


def synapse_apply_plain(edges, msg_lid, msg_gid, msg_valid, req_lid, req_src,
                        req_valid, req_prio, vacant_d):
    """remove -> compact -> accept. Returns (new_edges, accept (qr,) bool)."""
    out = syn.compact(syn.remove_edges_by_messages(edges, msg_lid, msg_gid,
                                                   msg_valid))
    accept, out = syn.accept_core(req_lid, req_src, req_valid, vacant_d, out,
                                  req_prio)
    return out, accept


def route_build_plain(flat_other, flat_mine, *, n: int, num_ranks: int,
                      cap: int):
    """Returns (buf (num_ranks, cap, 2) int32, dropped (1,) f32)."""
    buf, dropped = routing.route_build_core(flat_other, flat_mine, n,
                                            num_ranks, cap, bucket_ranks)
    return buf, dropped.reshape(1)


def synapse_apply(edges, msg_lid, msg_gid, msg_valid, req_lid, req_src,
                  req_valid, req_prio, vacant_d):
    """One remove -> compact -> accept pass over one edge table (K4).

    edges: (n, S) int32; msg_*: (qm,) deletion messages (row, gid, valid);
    req_*: (qr,) formation requests (row, source gid, valid, priority f32);
    vacant_d: (n,) f32. Returns (new_edges, accept (qr,) bool)."""
    if edges.device.type != "cuda":
        return synapse_apply_plain(edges, msg_lid, msg_gid, msg_valid,
                                   req_lid, req_src, req_valid, req_prio,
                                   vacant_d)
    n, s_max = edges.shape
    if s_max > 32:
        raise ValueError(f"synapse_apply: at most 32 slots a row, got {s_max}")
    qm, qr = msg_lid.shape[0], req_lid.shape[0]
    dev = edges.device
    i32 = torch.int32
    tbl = edges.to(i32).contiguous()
    mlid, mgid = (x.to(i32).contiguous() for x in (msg_lid, msg_gid))
    mval = msg_valid.to(torch.uint8).contiguous()
    rlid, rsrc = (x.to(i32).contiguous() for x in (req_lid, req_src))
    rval = req_valid.to(torch.uint8).contiguous()
    prio = req_prio.to(torch.float32).contiguous()
    vac = vacant_d.to(torch.float32).contiguous()
    out = torch.empty_like(tbl)
    accept = torch.empty(qr, dtype=torch.bool, device=dev)   # bytes 0 / 1
    lib = _build.library()
    words = lib.repro_synapse_apply_workspace(n, qm, qr)
    work = torch.empty(words, dtype=i32, device=dev)
    _build.require_cuda("synapse_apply", tbl, mlid, mgid, mval, rlid, rsrc,
                        rval, prio, vac, out, accept, work)
    if (mgid.shape[0], mval.shape[0]) != (qm, qm) or \
            (rsrc.shape[0], rval.shape[0], prio.shape[0]) != (qr, qr, qr) or \
            vac.shape != (n,):
        raise ValueError("synapse_apply: message, request and vacancy "
                         "operands disagree in length")
    _build.check(lib.repro_synapse_apply(
        tbl.data_ptr(), out.data_ptr(), mlid.data_ptr(), mgid.data_ptr(),
        mval.data_ptr(), rlid.data_ptr(), rsrc.data_ptr(), rval.data_ptr(),
        prio.data_ptr(), vac.data_ptr(), accept.data_ptr(), work.data_ptr(),
        words, n, s_max, qm, qr, _build.stream()), "synapse_apply")
    apply_launches.add()
    return out, accept


def route_build(flat_other, flat_mine, *, n: int, num_ranks: int, cap: int):
    """Deletion-notification buffers over the flattened (n*S,) (partner gid,
    my gid) pairs (K5). Returns (buf (num_ranks, cap, 2) int32, dropped (1,)
    f32)."""
    if flat_other.device.type != "cuda":
        return route_build_plain(flat_other, flat_mine, n=n,
                                 num_ranks=num_ranks, cap=cap)
    if not 1 <= num_ranks <= MAX_RANKS:
        raise ValueError(f"route_build: {num_ranks} ranks outside "
                         f"[1, {MAX_RANKS}]")
    if cap < 0 or num_ranks * cap > MAX_SLOTS:
        raise ValueError(f"route_build: {num_ranks} x {cap} slots outside "
                         f"[0, {MAX_SLOTS}]")
    m = flat_other.shape[0]
    if m > MAX_SLOTS:
        raise ValueError(f"route_build: {m} entries above {MAX_SLOTS}")
    dev = flat_other.device
    i32 = torch.int32
    other = flat_other.to(i32).contiguous()
    mine = flat_mine.to(i32).contiguous()
    if mine.shape != (m,):
        raise ValueError("route_build: flat_other and flat_mine differ in "
                         "length")
    buf = torch.empty((num_ranks, cap, 2), dtype=i32, device=dev)
    dropped = torch.empty(1, dtype=torch.float32, device=dev)
    words = _route_workspace(dev.index, m, num_ranks)
    stream = _build.stream(dev.index)
    counts = _build.scratch(dev, stream, words)
    _build.require_cuda("route_build", other, mine, buf, dropped)
    _build.check(_build.library().repro_route_build(
        other.data_ptr(), mine.data_ptr(), buf.data_ptr(), dropped.data_ptr(),
        counts.data_ptr(), words, m, n, num_ranks, cap, stream),
        "route_build")
    route_launches.add()
    return buf, dropped
