"""The collectives between ranks: one ``Comm`` per rank, three collectives.

The JAX package runs every rank's chunk under ``shard_map`` on a 1-D
``ranks`` mesh (``repro/core/engine.py::make_brain_mesh``,
``repro/sim/api.py``); its phases call three collectives. A ``Comm`` offers
exactly those, with jax's semantics:

- ``all_gather(x)``: every rank's ``x`` concatenated along axis 0 in rank
  order (``jax.lax.all_gather(..., tiled=True)``);
- ``all_to_all(buf)``: ``buf`` is ``(R, cap, ...)``; row ``d`` of rank
  ``s``'s buffer lands in row ``s`` of rank ``d``'s
  (``jax.lax.all_to_all(buf, axis, 0, 0, tiled=True)``);
- ``psum(x)``: the sum over ranks, the same on every rank.

Three transports:

- ``SelfComm``: one rank; every collective is the identity.
- ``LocalComm``: R ranks in one process on one device. Each rank runs its
  unchanged code in a thread of its own, and a baton lets exactly one rank
  run at a time, in rank order: at a collective a rank deposits its tensor
  and hands the baton on; the last rank computes the exchange with tensor
  ops on the device, and the ranks resume one at a time in order. Nothing
  of the exchange goes through the host, and no two ranks ever launch
  kernels at once (the kernels' launch counters and cached scratch are not
  shared safely between concurrent callers). All ranks use the caller's
  current stream. An exception in one rank aborts the others and is raised
  again in the caller. In a profile, ``repro.comm.exchange`` is the
  exchange's tensor ops and ``repro.comm.wait`` a rank's wait for the
  baton.
- ``ProcessGroupComm``: one rank per process, over ``torch.distributed``
  (``all_gather_into_tensor``, ``all_to_all_single`` with equal splits,
  ``all_reduce``): gloo on CPU tensors, NCCL with ``cuda:LOCAL_RANK`` on a
  machine with several cards.

Collective outputs are read, never written in place, as jax's arrays.

The LM stack's sharded paths run on a mesh of named axes (``pod``,
``data``, ``model``, ``stage``), as the JAX package's ``shard_map`` code
does (``repro/models/moe.py``, ``models/attention.py``,
``models/transformer.py``, ``optim/periodic.py``, ``parallel/pipeline.py``).
A ``Mesh`` is the shape and the axis names, ranks numbered row-major (the
last axis fastest, as jax reshapes its device array); a ``MeshComm`` is one
rank's view of it, with jax's collectives over an axis or a tuple of axes
(the tuple's ranks in the tuple's order, the first axis slowest):
``all_gather`` (tiled), ``all_to_all`` (tiled), ``psum``, ``pmax``,
``pmean``, ``psum_scatter`` (tiled), ``ppermute`` and ``axis_index``. An
axis line is the set of ranks that differ only along the named axes.

Two transports: ``LocalMesh`` runs every rank in this process on today's
baton (each rank deposits (op, axes, x); the last to arrive computes each
axis line's result; ranks that reach different ops raise), and
``ProcessMesh`` is this process's rank, one ``torch.distributed.new_group``
a line. Under autograd a collective is differentiated as ``shard_map``
transposes it: ``all_gather``'s backward is a reduce-scatter,
``all_to_all``'s the inverse ``all_to_all``, ``psum``'s a ``psum``,
``ppermute``'s the inverse permutation (``pmax`` is not differentiated).
On the baton the exchange is one autograd node over every rank's tensor,
so one ``torch.autograd.backward`` over all ranks' losses runs the whole
backward in the calling thread, with no rank waiting on another
(``backward_ranks``). Remat there is ``MeshComm.checkpoint``: every
rank's region is recomputed together, behind the baton, when the backward
first needs it (``LocalMesh``).

Two transports count rather than move (the dry run, ``launch/dryrun.py``):
``ShapeMesh`` runs one rank of a mesh on ``meta`` tensors, its collectives
computing only their output's shape; ``LoneComm`` is one real rank of a
brain group whose other ranks are absent (zeros in their rows). Each keeps
a ``Collective`` record of every op it runs, forward and backward, with the
op's line size, operand and result bytes and whether its line stays inside
one node of ``NODE_SIZE`` consecutive ranks. ``repeat(n)`` makes what is
recorded inside count ``n`` times, and ``repeated(n, fn, ...)`` a step
under autograd, its backward too (a loop traced for one step).
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import functools
import itertools
import math
import threading
from typing import Callable, List, Sequence, Tuple, Union

import torch
from torch.profiler import record_function
from torch.utils import _pytree as pytree


class Comm:
    """One rank's view of the group: ``rank``, ``num_ranks`` and the three
    collectives."""
    rank: int = 0
    num_ranks: int = 1

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def all_to_all(self, buf: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError


class SelfComm(Comm):
    """The group of one rank: every collective returns its operand."""

    def all_gather(self, x):
        return x

    def all_to_all(self, buf):
        _check_rows(buf, 1)
        return buf

    def psum(self, x):
        return x


SINGLE = SelfComm()


def _check_rows(buf, num_ranks: int) -> None:
    if buf.dim() < 1 or buf.shape[0] != num_ranks:
        raise ValueError(f"all_to_all: the buffer's leading axis must be the "
                         f"rank count {num_ranks}, got shape "
                         f"{tuple(buf.shape)}")


# ------------------------------------------------------------ one process
class _Aborted(Exception):
    """Raised in a waiting rank when another rank failed."""


def _gather(parts: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    out = torch.cat(list(parts), 0)
    return [out] * len(parts)


def _all_to_all(parts: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    r = len(parts)
    for p in parts:
        _check_rows(p, r)
    return [torch.stack([parts[s][d] for s in range(r)]) for d in range(r)]


def _psum(parts: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    # summed in rank order: every rank gets the same bits
    out = torch.stack(list(parts)).sum(0)
    return [out] * len(parts)


_EXIT = "exit"
_OPS = {"all_gather": _gather, "all_to_all": _all_to_all, "psum": _psum,
        _EXIT: lambda parts: [None] * len(parts)}


class LocalComm:
    """R ranks in one process: ``run`` calls one function per rank, each in
    its own thread (named ``repro-rank-<r>``), passing the baton in rank
    order. ``comm(r)`` is rank ``r``'s ``Comm`` (hand it to that rank's
    code)."""

    def __init__(self, num_ranks: int, mesh: "Mesh" = None):
        if num_ranks < 1:
            raise ValueError(f"LocalComm: {num_ranks} ranks")
        self.num_ranks = num_ranks
        self.mesh = mesh
        self._comms = [_LocalRankComm(self, r) for r in range(num_ranks)]
        # one lock, a condition a rank: handing the baton on wakes only the
        # rank whose turn it is
        self._cv = threading.Condition()
        self._cvs = [threading.Condition(self._cv._lock)
                     for _ in range(num_ranks)]
        self._running = False

    def comm(self, rank: int) -> Comm:
        return self._comms[rank]

    # the baton: ``_turn`` is the rank that may run; ``_slots`` the tensors
    # deposited at the current collective, ``_results`` the last exchange's
    def _wait_turn(self, rank: int) -> None:
        with record_function("repro.comm.wait"):
            self._cvs[rank].wait_for(lambda: self._turn == rank or
                                     self._error)
        if self._error:
            raise _Aborted()

    def _collective(self, rank: int, op: str, x):
        with self._cv:
            if self._error:
                raise _Aborted()
            self._slots[rank] = (op, x)
            if rank == self.num_ranks - 1:
                ops = {s[0] for s in self._slots}
                if len(ops) != 1:
                    raise RuntimeError(
                        "LocalComm: the ranks reached different collectives "
                        f"({[s[0] for s in self._slots]})")
                parts = [s[1] for s in self._slots]
                with record_function("repro.comm.exchange"):
                    self._results = _OPS[op](parts) if isinstance(op, str) \
                        else _EXCHANGES[op[0]](self.mesh, op, parts)
                self._slots = [None] * self.num_ranks
            self._turn = (rank + 1) % self.num_ranks
            self._cvs[self._turn].notify()
            if op == _EXIT:
                return None
            self._wait_turn(rank)
            return self._results[rank]

    def _fail(self, err: BaseException) -> None:
        with self._cv:
            if not self._error:
                self._error.append(err)
            for cv in self._cvs:
                cv.notify_all()

    def run(self, fns: Sequence[Callable[[], object]], device=None) -> list:
        """Call ``fns[r]()`` as rank ``r`` for every rank, one at a time
        between collectives, and return their results in rank order. On a
        CUDA ``device`` every rank launches on the caller's current stream
        of that device."""
        if len(fns) != self.num_ranks:
            raise ValueError(f"LocalComm.run: {len(fns)} functions for "
                             f"{self.num_ranks} ranks")
        if self._running:
            raise RuntimeError("LocalComm.run: the group is already running")
        device = None if device is None else torch.device(device)
        cuda = device is not None and device.type == "cuda"
        if cuda and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        stream = torch.cuda.current_stream(device) if cuda else None
        self._running = True
        self._turn = 0
        self._error: list = []
        self._slots = [None] * self.num_ranks
        self._results = None
        results = [None] * self.num_ranks

        def body(rank: int) -> None:
            try:
                if cuda:
                    torch.cuda.set_device(device)
                    torch.cuda.set_stream(stream)
                with self._cv:
                    self._wait_turn(rank)
                results[rank] = fns[rank]()
                self._collective(rank, _EXIT, None)
            except _Aborted:
                pass
            except BaseException as e:   # noqa: B902 - re-raised below
                self._fail(e)

        threads = [threading.Thread(target=body, args=(r,),
                                    name=f"repro-rank-{r}", daemon=True)
                   for r in range(self.num_ranks)]
        try:
            for t in threads:
                t.start()
            for t in threads:
                t.join()
        finally:
            self._running = False
        if self._error:
            raise self._error[0]
        return results


def map_ranks(group, num_ranks: int, body: Callable[[int], object],
              device=None) -> list:
    """``[body(i) for i in range(num_ranks)]``: a plain call for one rank
    (``group`` None), else each as rank ``i`` of the ``LocalComm``
    ``group`` (one thread a rank behind the baton)."""
    if group is None:
        return [body(0)]
    return group.run([functools.partial(body, i) for i in range(num_ranks)],
                     device=device)


class _LocalRankComm(Comm):
    def __init__(self, group: LocalComm, rank: int):
        self.group = group
        self.rank = rank
        self.num_ranks = group.num_ranks

    def all_gather(self, x):
        return self.group._collective(self.rank, "all_gather", x)

    def all_to_all(self, buf):
        return self.group._collective(self.rank, "all_to_all", buf)

    def psum(self, x):
        return self.group._collective(self.rank, "psum", x)


# ------------------------------------------------------ one rank a process
class ProcessGroupComm(Comm):
    """This process's rank of a ``torch.distributed`` group (the default
    group unless one is given). gloo takes CPU tensors; NCCL takes tensors
    on this process's card."""

    def __init__(self, group=None):
        import torch.distributed as tdist
        if not tdist.is_initialized():
            raise RuntimeError("ProcessGroupComm: call torch.distributed."
                               "init_process_group first")
        self._dist = tdist
        self.group = group
        self.rank = tdist.get_rank(group)
        self.num_ranks = tdist.get_world_size(group)

    def all_gather(self, x):
        x = x.contiguous()
        out = torch.empty((self.num_ranks * x.shape[0],) + tuple(x.shape[1:]),
                          dtype=x.dtype, device=x.device)
        self._dist.all_gather_into_tensor(out, x, group=self.group)
        return out

    def all_to_all(self, buf):
        _check_rows(buf, self.num_ranks)
        buf = buf.contiguous()
        out = torch.empty_like(buf)
        self._dist.all_to_all_single(out, buf, group=self.group)
        return out

    def psum(self, x):
        out = x.clone()
        self._dist.all_reduce(out, group=self.group)
        return out


# ====================================================== meshes of named axes
Axes = Union[str, Tuple[str, ...], None]


def _axes(axes: Axes) -> Tuple[str, ...]:
    if axes is None:
        return ()
    return (axes,) if isinstance(axes, str) else tuple(axes)


class Mesh:
    """The shape of a mesh and its axis names; rank ``r`` sits at
    ``coords(r)``, row-major. ``shape`` maps each name to its size, as
    jax's ``Mesh.shape``."""

    def __init__(self, shape, axis_names):
        shape, axis_names = tuple(int(s) for s in shape), tuple(axis_names)
        if len(shape) != len(axis_names) or len(set(axis_names)) != \
                len(axis_names) or min(shape, default=1) < 1:
            raise ValueError(f"Mesh: shape {shape} for axes {axis_names}")
        self.axis_names = axis_names
        self.shape = dict(zip(axis_names, shape))
        self.size = math.prod(shape)
        # bytes reaching each rank, by (comm_scope, collective), summed over
        # this process's ranks
        self.bytes = {}
        self._lines = {}

    def __repr__(self):
        return f"Mesh({self.shape})"

    def coords(self, rank: int) -> Tuple[int, ...]:
        out = []
        for n in reversed(list(self.shape.values())):
            out.append(rank % n)
            rank //= n
        return tuple(reversed(out))

    def rank_of(self, coords) -> int:
        r = 0
        for c, n in zip(coords, self.shape.values()):
            r = r * n + c
        return r

    def axis_size(self, axes: Axes) -> int:
        return math.prod(self.shape[a] for a in _axes(axes))

    def axis_index(self, rank: int, axes: Axes) -> int:
        """``rank``'s position along ``axes`` (the first axis slowest)."""
        c = dict(zip(self.axis_names, self.coords(rank)))
        i = 0
        for a in _axes(axes):
            i = i * self.shape[a] + c[a]
        return i

    def line(self, rank: int, axes: Axes) -> List[int]:
        """The ranks of ``rank``'s line along ``axes``, by their position
        along them."""
        axes = _axes(axes)
        for a in axes:
            if a not in self.shape:
                raise ValueError(f"{self}: no axis {a!r}")
        base = list(self.coords(rank))
        pos = [self.axis_names.index(a) for a in axes]
        out = []
        for idx in itertools.product(*(range(self.shape[a]) for a in axes)):
            c = list(base)
            for p, i in zip(pos, idx):
                c[p] = i
            out.append(self.rank_of(c))
        return out

    def lines(self, axes: Axes) -> List[List[int]]:
        """Every line along ``axes``, each once, by its first rank."""
        key = _axes(axes)
        if key not in self._lines:
            seen, out = set(), []
            for r in range(self.size):
                ln = self.line(r, key)
                if ln[0] not in seen:
                    seen.add(ln[0])
                    out.append(ln)
            self._lines[key] = out
        return self._lines[key]

    def checkpoint(self, rank, fn, args, context_fn=None):
        """Rank ``rank``'s ``fn(*args)`` keeping none of its activations,
        recomputed in its backward: non-reentrant ``torch.utils.checkpoint``,
        where each rank runs its own backward (``LocalMesh`` overrides)."""
        from torch.utils import checkpoint as ckpt
        return ckpt.checkpoint(fn, *args, use_reentrant=False,
                               context_fn=context_fn or ckpt.noop_context_fn)


# the collectives on a line, as functions of the line's tensors in line
# order; each returns the line's results in that order
def _line_all_gather(xs, dim):
    out = torch.cat(list(xs), dim)
    return [out] * len(xs)


def _line_psum_scatter(xs, dim):
    total = torch.stack(list(xs)).sum(0)
    return list(torch.chunk(total, len(xs), dim))


def _line_all_to_all(xs, split, concat):
    n = len(xs)
    parts = [torch.chunk(x, n, split) for x in xs]
    return [torch.cat([parts[s][d] for s in range(n)], concat)
            for d in range(n)]


def _line_psum(xs):
    out = torch.stack(list(xs)).sum(0)       # summed in line order
    return [out] * len(xs)


def _line_pmax(xs):
    out = torch.stack(list(xs)).amax(0)
    return [out] * len(xs)


def _line_ppermute(xs, perm):
    out = [torch.zeros_like(x) for x in xs]
    for src, dst in perm:
        out[dst] = xs[src]
    return out


def _line_op(kind: str, params, xs):
    if kind == "all_gather":
        return _line_all_gather(xs, params[0])
    if kind == "psum_scatter":
        return _line_psum_scatter(xs, params[0])
    if kind == "all_to_all":
        return _line_all_to_all(xs, *params)
    if kind == "psum":
        return _line_psum(xs)
    if kind == "pmean":
        return [y / len(xs) for y in _line_psum(xs)]
    if kind == "pmax":
        return _line_pmax(xs)
    if kind == "ppermute":
        return _line_ppermute(xs, params[0])
    raise ValueError(f"unknown collective {kind!r}")


def _transpose(kind: str, params):
    """The collective that ``kind``'s backward runs on the cotangents."""
    if kind == "all_gather":
        return "psum_scatter", params
    if kind == "psum_scatter":
        return "all_gather", params
    if kind == "all_to_all":
        return "all_to_all", (params[1], params[0])
    if kind in ("psum", "pmean"):
        return kind, params
    if kind == "ppermute":
        return "ppermute", (tuple((d, s) for s, d in params[0]),)
    raise RuntimeError(f"{kind} is not differentiated")


def _mesh_apply(mesh: Mesh, kind, axes, params, parts):
    """Every rank's result of one collective: each line computed alone."""
    out = [None] * mesh.size
    for ln in mesh.lines(axes):
        res = _line_op(kind, params, [parts[r] for r in ln])
        for r, y in zip(ln, res):
            out[r] = y
    return out


class _MeshExchange(torch.autograd.Function):
    """One collective over every rank's tensor: one node, so the backward
    of all ranks runs as one (the transposed collective)."""

    @staticmethod
    def forward(ctx, mesh, kind, axes, params, *parts):
        ctx.mesh, ctx.kind, ctx.axes, ctx.params = mesh, kind, axes, params
        out, seen = [], {id(p) for p in parts}
        for y in _mesh_apply(mesh, kind, axes, params, parts):
            # a tensor of its own a rank: a node's outputs must be
            # distinct, and none of them an input
            out.append(y.clone() if id(y) in seen else y)
            seen.add(id(y))
        if kind == "pmax":
            ctx.mark_non_differentiable(*out)
        return tuple(out)

    @staticmethod
    def backward(ctx, *cts):
        kind, params = _transpose(ctx.kind, ctx.params)
        return (None, None, None, None) + tuple(_mesh_apply(
            ctx.mesh, kind, ctx.axes, params, list(cts)))


def _mesh_exchange(mesh: Mesh, op, parts):
    _, kind, axes, params = op
    if torch.is_grad_enabled() and any(p.requires_grad for p in parts):
        return list(_MeshExchange.apply(mesh, kind, axes, params, *parts))
    return _mesh_apply(mesh, kind, axes, params, parts)


# --------------------------------------------- a checkpoint across the baton
class _StopRecompute(Exception):
    """Raised in a rank's recompute once it has saved every tensor its
    forward saved: what follows (a trailing collective) is not run again."""


class _Region:
    """One rank's call of a ``LocalMesh`` checkpoint. Its forward keeps none
    of the tensors autograd saves (``pack`` leaves their index) and its
    recompute saves them again in the same order, stopping after the last
    one: ``torch.utils.checkpoint``'s non-reentrant scheme, early stop
    included, so a rank's recompute runs the collectives that a
    ``ShapeMesh`` or ``ProcessMesh`` rank's runs."""

    def __init__(self, fn, args, contexts):
        self.fn, self.args = fn, args
        # the rank's context (its mesh, layout, batch split and comm scope)
        # for the recompute, which runs in a thread of its own
        self.context = contextvars.copy_context()
        self.forward_context, self.recompute_context = contexts
        self.n_saved = 0
        self.saved = {}
        self.checkpoint = None

    def pack(self, x):
        self.n_saved += 1
        return self.n_saved - 1

    def unpack(self, i):
        self.checkpoint.recompute()
        if i not in self.saved:
            raise RuntimeError("a LocalMesh checkpoint's saved tensor was "
                               "read twice: one backward through it only")
        return self.saved.pop(i)

    def recompute(self) -> None:
        if not self.n_saved:
            return
        n = 0

        def pack(x):
            nonlocal n
            if n == self.n_saved:
                raise RuntimeError("LocalMesh checkpoint: the recompute saves "
                                   "more tensors than the forward")
            self.saved[n] = x.detach()
            n += 1
            if n == self.n_saved:
                raise _StopRecompute
            return None

        def unpack(_):
            raise RuntimeError("LocalMesh checkpoint: a backward inside the "
                               "recompute")
        args = pytree.tree_map_only(
            torch.Tensor, lambda x: x.detach().requires_grad_(x.requires_grad),
            self.args)
        try:
            with torch.enable_grad(), \
                    torch.autograd.graph.saved_tensors_hooks(pack, unpack), \
                    self.recompute_context:
                self.context.run(self.fn, *args)
        except _StopRecompute:
            pass
        if n != self.n_saved:
            raise RuntimeError(f"LocalMesh checkpoint: the recompute saved {n} "
                               f"of the forward's {self.n_saved} tensors")


class _Checkpoint:
    """One checkpoint over every rank of a ``LocalMesh``: the first saved
    tensor the backward reads recomputes every rank's region together,
    each in its rank's thread behind the baton, as the forward ran."""

    def __init__(self, mesh, regions):
        self.mesh, self.regions, self.done = mesh, list(regions), False
        for r in self.regions:
            r.checkpoint = self

    def recompute(self) -> None:
        with self.mesh.recompute_lock:
            if self.done:
                return
            dev = next((x.device for x in pytree.tree_leaves(
                self.regions[0].args) if isinstance(x, torch.Tensor)), None)
            self.mesh.group.run([r.recompute for r in self.regions],
                                device=dev)
            self.done = True


def _join_regions(mesh, op, regions):
    ck = _Checkpoint(mesh, regions)
    return [ck] * len(regions)


_EXCHANGES = {"mesh": _mesh_exchange, "checkpoint": _join_regions}


_scope_var: contextvars.ContextVar = contextvars.ContextVar("repro_scope",
                                                            default="")


@contextlib.contextmanager
def comm_scope(name: str):
    """Count the collectives inside under ``name`` (``Mesh.bytes``)."""
    tok = _scope_var.set(name)
    try:
        yield
    finally:
        _scope_var.reset(tok)


def _arriving_bytes(kind: str, n: int, nbytes: int) -> int:
    """Bytes reaching a rank from the others of its line of ``n``: a
    gather, a reduction or a permutation moves (n-1) blocks of the
    operand's size in, an all_to_all or reduce-scatter (n-1)/n of it."""
    if kind in ("all_to_all", "psum_scatter"):
        return nbytes * (n - 1) // n
    if kind == "ppermute":
        return nbytes
    return nbytes * (n - 1)


class MeshComm:
    """One rank's view of a mesh: ``shape``, ``axis_names``, ``size``,
    ``rank`` and the collectives over named axes. Model code takes it as its
    ``mesh`` argument, where the JAX package takes a ``Mesh``. An empty
    tuple of axes, or axes of size 1, makes a collective the identity (as
    under ``shard_map``)."""

    def __init__(self, mesh: Mesh, rank: int, transport):
        self.mesh = mesh
        self.rank = rank
        self.shape = mesh.shape
        self.axis_names = mesh.axis_names
        self.size = mesh.size
        self._t = transport

    def __repr__(self):
        return f"MeshComm(rank {self.rank} of {self.mesh})"

    def without(self, axes: Axes) -> "MeshComm":
        """This rank's view of the mesh with ``axes`` hidden: its sub-mesh
        along the others (the code inside sees only those, as JAX code
        inside a ``shard_map`` manual over ``axes``)."""
        drop = set(_axes(axes))
        out = MeshComm(self.mesh, self.rank, self._t)
        out.axis_names = tuple(a for a in self.axis_names if a not in drop)
        out.shape = {a: self.shape[a] for a in out.axis_names}
        out.size = math.prod(out.shape.values())
        return out

    def axis_index(self, axes: Axes) -> int:
        return self.mesh.axis_index(self.rank, axes)

    def axis_size(self, axes: Axes) -> int:
        return self.mesh.axis_size(axes)

    def _run(self, kind, axes, params, x):
        axes = _axes(axes)
        n = self.mesh.axis_size(axes)
        if n > 1:
            key = (_scope_var.get(), kind)
            self.mesh.bytes[key] = self.mesh.bytes.get(key, 0) + \
                _arriving_bytes(kind, n, x.numel() * x.element_size())
        if n == 1:
            if kind == "ppermute":
                return x if (0, 0) in params[0] else torch.zeros_like(x)
            return x
        return self._t.collective(self.rank, kind, axes, params, x)

    def all_gather(self, x, axes: Axes, dim: int = 0):
        """The line's ``x`` concatenated along ``dim`` in line order
        (``jax.lax.all_gather(..., axis=dim, tiled=True)``)."""
        return self._run("all_gather", axes, (dim % x.dim(),), x)

    def psum_scatter(self, x, axes: Axes, dim: int = 0):
        """The line's sum, this rank's block of it along ``dim``
        (``jax.lax.psum_scatter(..., scatter_dimension=dim, tiled=True)``)."""
        return self._run("psum_scatter", axes, (dim % x.dim(),), x)

    def all_to_all(self, x, axes: Axes, split_dim: int = 0,
                   concat_dim: int = 0):
        """Block ``d`` of ``x`` along ``split_dim`` goes to the line's rank
        ``d``, which concatenates what it receives along ``concat_dim`` in
        line order (``jax.lax.all_to_all(..., tiled=True)``)."""
        return self._run("all_to_all", axes,
                         (split_dim % x.dim(), concat_dim % x.dim()), x)

    def psum(self, x, axes: Axes):
        return self._run("psum", axes, (), x)

    def pmean(self, x, axes: Axes):
        return self._run("pmean", axes, (), x)

    def pmax(self, x, axes: Axes):
        return self._run("pmax", axes, (), x)

    def ppermute(self, x, axis: Axes, perm):
        """``perm``: (source, destination) positions along ``axis``; a rank
        that is no destination gets zeros (``jax.lax.ppermute``, which
        numbers the positions along a tuple of axes in the mesh's order of
        them)."""
        names = _axes(axis)
        axis = tuple(a for a in self.axis_names if a in names)
        return self._run("ppermute", axis,
                         (tuple((int(s), int(d)) for s, d in perm),), x)

    def checkpoint(self, fn, *args, context_fn=None):
        """``fn(*args)`` keeping none of its activations, recomputed in the
        backward as the transport does it (``Mesh.checkpoint``; on a
        ``LocalMesh`` every rank's together). ``context_fn``: as
        ``torch.utils.checkpoint``'s, a pair of contexts for the forward and
        the recompute (``create_selective_checkpoint_contexts``)."""
        return self._t.checkpoint(self.rank, fn, args, context_fn)


class LocalMesh(Mesh):
    """Every rank of the mesh in this process, on one device, behind
    ``LocalComm``'s baton: ``run(fn)`` calls ``fn(comm(r))`` for every
    rank ``r`` and returns the results in rank order.

    ``checkpoint`` is remat on the baton. Every rank's backward runs as one
    in the calling thread, so rank r's layer cannot be recomputed alone
    there: its collectives would wait for ranks that never come. Each rank
    enters the checkpoint (a rendezvous that joins the ranks' regions into
    one ``_Checkpoint``) and runs ``fn`` keeping no saved tensor; when the
    backward first reads one, every rank's ``fn`` runs again under
    ``group.run``, in its thread behind the baton with its own context, and
    refills what it saved."""

    def __init__(self, shape, axis_names):
        super().__init__(shape, axis_names)
        self.group = LocalComm(self.size, mesh=self)
        self._comms = [MeshComm(self, r, self) for r in range(self.size)]
        self.ranks = list(range(self.size))
        self.recompute_lock = threading.Lock()

    def comm(self, rank: int) -> MeshComm:
        return self._comms[rank]

    def collective(self, rank, kind, axes, params, x):
        return self.group._collective(rank, ("mesh", kind, axes, params), x)

    def checkpoint(self, rank, fn, args, context_fn=None):
        if self.size == 1:
            return super().checkpoint(rank, fn, args, context_fn)
        if not self.group._running:
            raise RuntimeError("LocalMesh.checkpoint: call it in a rank of "
                               "run()")
        contexts = context_fn() if context_fn is not None else (
            contextlib.nullcontext(), contextlib.nullcontext())
        region = _Region(fn, args, contexts)
        self.group._collective(rank, ("checkpoint",), region)
        with torch.autograd.graph.saved_tensors_hooks(region.pack,
                                                      region.unpack), \
                region.forward_context:
            return fn(*args)

    def run(self, fn: Callable[[MeshComm], object], device=None) -> list:
        if self.size == 1:
            return [fn(self._comms[0])]
        return self.group.run([functools.partial(fn, c) for c in self._comms],
                              device=device)


class _ProcExchange(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mesh, kind, axes, params, x):
        ctx.mesh, ctx.kind, ctx.axes, ctx.params = mesh, kind, axes, params
        out = mesh._raw(kind, axes, params, x)
        if kind == "pmax":
            ctx.mark_non_differentiable(out)
        return out

    @staticmethod
    def backward(ctx, ct):
        kind, params = _transpose(ctx.kind, ctx.params)
        return None, None, None, None, ctx.mesh._raw(kind, ctx.axes, params,
                                                     ct.contiguous())


class ProcessMesh(Mesh):
    """This process's rank of a mesh over ``torch.distributed`` (the world
    is the mesh, rank for rank): one group a line, made by every process in
    the same order the first time an axis tuple is used. ``run(fn)`` is
    ``[fn(comm)]``. gloo on CPU tensors; NCCL on one card a process is
    untried here."""

    def __init__(self, shape, axis_names):
        import torch.distributed as tdist
        super().__init__(shape, axis_names)
        if not tdist.is_initialized():
            raise RuntimeError("ProcessMesh: call torch.distributed."
                               "init_process_group first")
        if tdist.get_world_size() != self.size:
            raise ValueError(f"ProcessMesh: {self.size} ranks in a world of "
                             f"{tdist.get_world_size()}")
        self._dist = tdist
        self.rank = tdist.get_rank()
        self.ranks = [self.rank]
        self._comm = MeshComm(self, self.rank, self)
        self._groups = {}

    def comm(self, rank: int) -> MeshComm:
        if rank != self.rank:
            raise ValueError(f"rank {rank} is not this process's "
                             f"({self.rank})")
        return self._comm

    def run(self, fn, device=None) -> list:
        return [fn(self._comm)]

    def _group(self, axes):
        if axes not in self._groups:
            mine = None
            for ln in self.lines(axes):    # every process makes every group
                g = self._dist.new_group(ln)
                if self.rank in ln:
                    mine = (g, ln)
            self._groups[axes] = mine
        return self._groups[axes]

    def collective(self, rank, kind, axes, params, x):
        if torch.is_grad_enabled() and x.requires_grad:
            return _ProcExchange.apply(self, kind, axes, params, x)
        return self._raw(kind, axes, params, x)

    def _gathered(self, x, group, line):
        """Every line member's ``x`` in line order."""
        parts = [torch.empty_like(x) for _ in line]
        self._dist.all_gather(parts, x.contiguous(), group=group)
        order = sorted(line)                 # a group's ranks are sorted
        return [parts[order.index(r)] for r in line]

    def _raw(self, kind, axes, params, x):
        group, line = self._group(axes)
        me = line.index(self.rank)
        if kind in ("psum", "pmean", "pmax", "psum_scatter"):
            out = x.contiguous().clone()
            op = self._dist.ReduceOp.MAX if kind == "pmax" else \
                self._dist.ReduceOp.SUM
            self._dist.all_reduce(out, op=op, group=group)
            if kind == "pmean":
                out = out / len(line)
            if kind == "psum_scatter":
                out = torch.chunk(out, len(line), params[0])[me].contiguous()
            return out
        parts = self._gathered(x, group, line)
        if kind == "all_gather":
            return torch.cat(parts, params[0])
        if kind == "all_to_all":
            split, concat = params
            return torch.cat([torch.chunk(p, len(line), split)[me]
                              for p in parts], concat)
        if kind == "ppermute":
            for src, dst in params[0]:
                if dst == me:
                    return parts[src].clone()
            return torch.zeros_like(x)
        raise ValueError(f"unknown collective {kind!r}")


def backward_ranks(losses, scale: float):
    """The backward of every rank's loss at once, in the calling thread:
    each seeded with ``scale`` (1 / the mesh's rank count is the cotangent
    ``shard_map`` gives a replicated output)."""
    torch.autograd.backward(list(losses), [torch.full_like(x, scale)
                                           for x in losses])


# ============================================= transports that only count
NODE_SIZE = 8      # ranks a node (8 GPUs an NVLink domain); row-major ranks

_times_var: contextvars.ContextVar = contextvars.ContextVar("repro_times",
                                                            default=1)


def count_times() -> int:
    """How many times what is counted now counts (``repeat``)."""
    return _times_var.get()


@contextlib.contextmanager
def repeat(n: int):
    """What is counted inside (collective records, ``StepCounter``'s ops)
    counts ``n`` times: a loop of ``n`` equal steps traced for one."""
    tok = _times_var.set(_times_var.get() * int(n))
    try:
        yield
    finally:
        _times_var.reset(tok)


def _keep(x):
    return x


class _Repeated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, n, fn, spec, holder, *flat):
        ins = [x.detach().requires_grad_(x.requires_grad)
               if isinstance(x, torch.Tensor) else x for x in flat]
        # the inner graph keeps what it saves: a checkpoint's hooks around
        # it would recompute the whole region at each inner unpack
        with torch.enable_grad(), repeat(n), \
                torch.autograd.graph.saved_tensors_hooks(_keep, _keep):
            out = fn(*pytree.tree_unflatten(ins, spec))
        outs, out_spec = pytree.tree_flatten(out)
        holder.append(out_spec)
        ctx.n, ctx.ins, ctx.outs = n, ins, outs
        return tuple(o.detach() for o in outs)

    @staticmethod
    def backward(ctx, *cts):
        pairs = [(o, c) for o, c in zip(ctx.outs, cts)
                 if o.requires_grad and c is not None]
        want = [i for i, x in enumerate(ctx.ins)
                if isinstance(x, torch.Tensor) and x.requires_grad]
        grads = [None] * len(ctx.ins)
        if pairs and want:
            with repeat(ctx.n):
                got = torch.autograd.grad(
                    [o for o, _ in pairs], [ctx.ins[i] for i in want],
                    [c for _, c in pairs], allow_unused=True)
            for i, g in zip(want, got):
                grads[i] = g
        return (None, None, None, None) + tuple(grads)


def repeated(n: int, fn, *args):
    """``fn(*args)`` (tensors in nested dicts / lists / tuples) counted as
    ``n`` calls: forward under ``repeat(n)`` and, where a gradient is
    wanted, its backward too. For a loop of ``n`` equal steps traced on
    ``meta`` for one step."""
    flat, spec = pytree.tree_flatten(args)
    if not torch.is_grad_enabled() or not any(
            isinstance(x, torch.Tensor) and x.requires_grad for x in flat):
        with repeat(n):
            return fn(*args)
    holder = []
    outs = _Repeated.apply(n, fn, spec, holder, *flat)
    return pytree.tree_unflatten(list(outs), holder[0])


@dataclasses.dataclass(frozen=True)
class Collective:
    """One collective as a rank ran it. ``kind`` is the port's name
    (``all_gather``, ``psum_scatter``, ``all_to_all``, ``psum``, ``pmean``,
    ``pmax``, ``ppermute``); ``n`` its line's size; ``arriving`` the bytes
    ``Mesh.bytes`` counts for it; ``times`` the ``repeat`` factor it ran
    under; ``backward`` whether autograd ran it."""
    kind: str
    axes: Tuple[str, ...]
    n: int
    operand_bytes: int
    result_bytes: int
    arriving: int
    intra_node: bool
    scope: str
    times: int = 1
    backward: bool = False


def _intra_node(line) -> bool:
    return min(line) // NODE_SIZE == max(line) // NODE_SIZE


def _out_shape(kind: str, params, shape, n: int) -> tuple:
    """The shape of a collective's result on a line of ``n`` ranks."""
    shape = list(shape)
    if kind == "all_gather":
        shape[params[0]] *= n
    elif kind == "psum_scatter":
        shape[params[0]] //= n
    elif kind == "all_to_all":
        split, concat = params
        shape[split] //= n
        shape[concat] *= n
    return tuple(shape)


class _ShapeExchange(torch.autograd.Function):
    """A ``ShapeMesh`` collective under autograd: its backward records and
    shapes the transposed collective, as ``_ProcExchange`` runs it."""

    @staticmethod
    def forward(ctx, mesh, kind, axes, params, x):
        ctx.mesh, ctx.kind, ctx.axes, ctx.params = mesh, kind, axes, params
        out = mesh._shape_op(kind, axes, params, x, False)
        if kind == "pmax":
            ctx.mark_non_differentiable(out)
        return out

    @staticmethod
    def backward(ctx, ct):
        kind, params = _transpose(ctx.kind, ctx.params)
        return None, None, None, None, ctx.mesh._shape_op(
            kind, ctx.axes, params, ct, True)


class ShapeMesh(Mesh):
    """One rank (``rank``) of a mesh, run alone on ``meta`` tensors: every
    collective returns zeros of its result's shape on its operand's device
    (an empty ``meta`` tensor there) and appends a ``Collective`` to
    ``records``; ``run(fn)`` is ``[fn(comm)]``. ``MeshComm._run`` counts
    its ``Mesh.bytes`` as on any mesh. The ranks of an SPMD step run the
    same ops on blocks of the same shapes, so one rank's records are a
    device's."""

    def __init__(self, shape, axis_names, rank: int = 0):
        super().__init__(shape, axis_names)
        if not 0 <= rank < self.size:
            raise ValueError(f"ShapeMesh: rank {rank} of {self.size}")
        self.rank = rank
        self.ranks = [rank]
        self.records: List[Collective] = []
        self._comm = MeshComm(self, rank, self)
        self._intra = {}

    def comm(self, rank: int) -> MeshComm:
        if rank != self.rank:
            raise ValueError(f"ShapeMesh: rank {rank} is not {self.rank}")
        return self._comm

    def run(self, fn, device=None) -> list:
        return [fn(self._comm)]

    def collective(self, rank, kind, axes, params, x):
        if torch.is_grad_enabled() and x.requires_grad:
            return _ShapeExchange.apply(self, kind, axes, params, x)
        return self._shape_op(kind, axes, params, x, False)

    def _shape_op(self, kind, axes, params, x, backward: bool):
        n = self.axis_size(axes)
        out = x.new_zeros(_out_shape(kind, params, x.shape, n))
        if axes not in self._intra:
            self._intra[axes] = _intra_node(self.line(self.rank, axes))
        ob = x.numel() * x.element_size()
        self.records.append(Collective(
            kind, tuple(axes), n, ob, out.numel() * out.element_size(),
            _arriving_bytes(kind, n, ob), self._intra[axes],
            _scope_var.get(), count_times(), backward))
        return out


class LoneComm(Comm):
    """Rank ``rank`` of a brain group of ``num_ranks`` whose other ranks are
    absent: ``all_gather`` returns the (R·n, ...) rows with this rank's in
    place and zeros for the others, ``all_to_all`` this rank's own block in
    place and zeros for the others, ``psum`` its operand; every call appends
    a ``Collective`` (axes ``("ranks",)``) to ``records``. The brain's
    buffers have static shapes, so the records are the real rank's whatever
    the others would have sent; the results are not a simulation's."""

    def __init__(self, num_ranks: int, rank: int = 0):
        if not 0 <= rank < num_ranks:
            raise ValueError(f"LoneComm: rank {rank} of {num_ranks}")
        self.num_ranks = num_ranks
        self.rank = rank
        self.records: List[Collective] = []
        self._intra = _intra_node(range(num_ranks))

    def _record(self, kind, x, out):
        ob = x.numel() * x.element_size()
        self.records.append(Collective(
            kind, ("ranks",), self.num_ranks, ob,
            out.numel() * out.element_size(),
            _arriving_bytes(kind, self.num_ranks, ob), self._intra,
            _scope_var.get(), count_times(), False))
        return out

    def all_gather(self, x):
        n = x.shape[0]
        out = x.new_zeros((self.num_ranks * n,) + tuple(x.shape[1:]))
        out[self.rank * n:(self.rank + 1) * n] = x
        return self._record("all_gather", x, out)

    def all_to_all(self, buf):
        _check_rows(buf, self.num_ranks)
        out = torch.zeros_like(buf)
        out[self.rank] = buf[self.rank]
        return self._record("all_to_all", buf, out)

    def psum(self, x):
        return self._record("psum", x, x)
