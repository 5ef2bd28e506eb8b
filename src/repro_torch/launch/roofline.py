"""The roofline of one step, counted from a traced rank (no card needed).

The port of the JAX package's ``repro/launch/roofline.py``. JAX compiles
the program and parses its post-SPMD HLO; the port runs one rank's step on
``meta`` tensors under a ``dist.ShapeMesh`` (or one real brain rank under
``dist.LoneComm``) and counts what that rank runs:

- ``StepCounter`` (a ``TorchDispatchMode``): the dot flops of every matrix
  product (``torch.utils.flop_counter``'s formulas for ``mm``, ``bmm``,
  ``addmm``, ``baddbmm`` and the convolutions), the bytes every op that is
  not a view writes (``materialized_bytes``), and the peak of the storage
  bytes alive at once that the step allocated (``peak_bytes``);
- the mesh's ``records``: every collective by kind and axis line, with its
  operand and result bytes, forward and backward;
- ``dist.repeat(n)``: what is counted inside counts ``n`` times, the
  counterpart of the HLO parser's while-loop trip counts; and
  ``dist.repeated(n, fn, ...)`` the same for a step under autograd, whose
  backward then counts ``n`` times too.

``analyze`` returns the JAX keys (``collective_logical_bytes``,
``collective_wire_bytes`` by JAX's kind names, ``collective_bytes_total``,
``dot_flops``): logical bytes are result bytes, wire bytes ``wire_factor``
times them (a reduce-scatter's ``n - 1`` times its result), as
``analyze_hlo`` defines them. It also keeps ``collective_arriving_bytes``:
what ``Mesh.bytes`` counts (a ``psum`` moves ``(n - 1)`` operands in, where
the ring model counts ``2 (n - 1) / n``), each under its own name.

``HW`` is NVIDIA's datasheet for the H100 SXM5 80GB at 700 W: 989e12 bf16
dense flop/s, 3.35e12 B/s of HBM, NVLink 4 at 450e9 B/s a direction a GPU
within a node of 8, InfiniBand NDR at 50e9 B/s a GPU across nodes. A
collective whose line stays inside a node is charged at NVLink's rate, any
other at InfiniBand's. The terms are analytic, not measured.
"""
from __future__ import annotations

import weakref
from collections import defaultdict

import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch import dist
from repro_torch.dist import count_times

HW = {
    "name": "NVIDIA H100 SXM5 80GB, 700 W (datasheet peaks)",
    "peak_flops_bf16": 989e12,   # dense, per GPU
    "hbm_bw": 3.35e12,           # bytes/s per GPU
    "hbm_bytes": 80e9,
    "links": {"nvlink": 450e9,   # NVLink 4, bytes/s a direction a GPU
              "ib": 50e9},       # InfiniBand NDR 400 Gb/s a GPU
    "node_size": dist.NODE_SIZE,
}

# the port's collective names -> the HLO op names JAX's records use
KINDS = {"all_gather": "all-gather", "psum": "all-reduce",
         "pmean": "all-reduce", "pmax": "all-reduce",
         "psum_scatter": "reduce-scatter", "all_to_all": "all-to-all",
         "ppermute": "collective-permute"}

_DOTS = {torch.ops.aten.mm, torch.ops.aten.bmm, torch.ops.aten.addmm,
         torch.ops.aten.baddbmm, torch.ops.aten.convolution,
         torch.ops.aten._convolution, torch.ops.aten.convolution_backward}


def wire_factor(kind: str, n: int) -> float:
    """Ring-algorithm bytes-on-the-wire per participant, as a fraction of the
    op's result bytes."""
    if n <= 1:
        return 0.0
    if kind.startswith("all-reduce"):
        return 2.0 * (n - 1) / n
    if kind.startswith("all-gather"):
        return (n - 1) / n
    if kind.startswith("reduce-scatter"):
        return (n - 1) / n      # relative to the (larger) input; see below
    if kind.startswith("all-to-all"):
        return (n - 1) / n
    if kind.startswith("collective-permute"):
        return 1.0
    return 1.0


class StepCounter(TorchDispatchMode):
    """Counts every aten op dispatched in this thread while it is entered
    (dispatch modes are per thread: on a ``LocalMesh`` enter one inside each
    rank's function). ``dot_flops`` and ``dot_flops_by_op``; ``ops``;
    ``materialized_bytes`` (outputs that alias no input, and in-place
    writes); ``peak_bytes`` of the storages the ops allocated alive at once
    (tracked by storage, freed by a weak reference's finaliser); all under
    the ``repeat`` factor but the peak."""

    def __init__(self):
        super().__init__()
        self.dot_flops = 0
        self.dot_flops_by_op = defaultdict(int)
        self.ops = 0
        self.materialized_bytes = 0
        self.live_bytes = 0
        self.peak_bytes = 0
        self._alive = {}

    def _free(self, key, nbytes):
        if self._alive.pop(key, None) is not None:
            self.live_bytes -= nbytes

    def _track(self, t):
        st = t.untyped_storage()
        key = id(st)
        if key in self._alive:
            return
        nb = st.nbytes()
        self._alive[key] = nb
        self.live_bytes += nb
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        weakref.finalize(st, self._free, key, nb)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        times = count_times()
        self.ops += times
        pkt = func._overloadpacket
        if pkt in _DOTS:
            f = int(flop_registry[pkt](*args, **kwargs, out_val=out))
            self.dot_flops += times * f
            self.dot_flops_by_op[pkt.__name__] += times * f
        rets = func._schema.returns
        for i, o in enumerate(pytree.tree_leaves(out)):
            if not isinstance(o, torch.Tensor):
                continue
            alias = rets[min(i, len(rets) - 1)].alias_info if rets else None
            if alias is None:
                self.materialized_bytes += times * o.numel() * \
                    o.element_size()
                self._track(o)
            elif alias.is_write:
                self.materialized_bytes += times * o.numel() * \
                    o.element_size()
        return out


def _link(rec, hw) -> str:
    links = list(hw["links"])
    return links[0] if rec.intra_node else links[-1]


def analyze(records, counter=None, hw=None):
    """Per-device totals of one traced step: JAX's keys (logical and wire
    bytes by kind, their total, dot flops) and the port's
    (``collective_wire_bytes_by_link``, ``collective_arriving_bytes`` by
    kind, ``collective_count``, ``materialized_bytes``, ``peak_bytes``,
    ``ops``)."""
    hw = hw or HW
    logical, wire, arriving = defaultdict(int), defaultdict(float), \
        defaultdict(int)
    by_link = {k: 0.0 for k in hw["links"]}
    count = 0
    for r in records:
        kind = KINDS[r.kind]
        w = r.result_bytes * (r.n - 1) if kind == "reduce-scatter" else \
            r.result_bytes * wire_factor(kind, r.n)
        logical[kind] += r.times * r.result_bytes
        wire[kind] += r.times * w
        arriving[kind] += r.times * r.arriving
        by_link[_link(r, hw)] += r.times * w
        count += r.times
    out = {"collective_logical_bytes": dict(logical),
           "collective_wire_bytes": dict(wire),
           "collective_bytes_total": float(sum(wire.values())),
           "collective_wire_bytes_by_link": by_link,
           "collective_arriving_bytes": dict(arriving),
           "collective_count": count,
           "dot_flops": float(counter.dot_flops) if counter else 0.0}
    if counter is not None:
        out.update(materialized_bytes=counter.materialized_bytes,
                   peak_bytes=counter.peak_bytes, ops=counter.ops)
    return out


def roofline_terms(dot_flops_per_dev: float, mem_bytes_per_dev: float,
                   coll_bytes_per_dev, hw=None):
    """Three roofline terms in seconds (per device, per step).
    ``coll_bytes_per_dev``: wire bytes by link (``hw["links"]``' names), or
    one number, all on the first link."""
    hw = hw or HW
    if not isinstance(coll_bytes_per_dev, dict):
        coll_bytes_per_dev = {next(iter(hw["links"])): coll_bytes_per_dev}
    t_compute = dot_flops_per_dev / hw["peak_flops_bf16"]
    t_memory = mem_bytes_per_dev / hw["hbm_bw"]
    t_coll = sum(b / hw["links"][k] for k, b in coll_bytes_per_dev.items())
    dominant = max((t_compute, "compute"), (t_memory, "memory"),
                   (t_coll, "collective"))
    return {"t_compute_s": t_compute, "t_memory_s": t_memory,
            "t_collective_s": t_coll, "dominant": dominant[1],
            "roofline_fraction": t_compute / max(
                t_compute, t_memory, t_coll, 1e-30)}
