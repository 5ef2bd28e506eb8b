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
"""
from __future__ import annotations

import functools
import threading
from typing import Callable, List, Sequence

import torch
from torch.profiler import record_function


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

    def __init__(self, num_ranks: int):
        if num_ranks < 1:
            raise ValueError(f"LocalComm: {num_ranks} ranks")
        self.num_ranks = num_ranks
        self._comms = [_LocalRankComm(self, r) for r in range(num_ranks)]
        self._cv = threading.Condition()
        self._running = False

    def comm(self, rank: int) -> Comm:
        return self._comms[rank]

    # the baton: ``_turn`` is the rank that may run; ``_slots`` the tensors
    # deposited at the current collective, ``_results`` the last exchange's
    def _wait_turn(self, rank: int) -> None:
        with record_function("repro.comm.wait"):
            self._cv.wait_for(lambda: self._turn == rank or self._error)
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
                with record_function("repro.comm.exchange"):
                    self._results = _OPS[op]([s[1] for s in self._slots])
                self._slots = [None] * self.num_ranks
            self._turn = (rank + 1) % self.num_ranks
            self._cv.notify_all()
            if op == _EXIT:
                return None
            self._wait_turn(rank)
            return self._results[rank]

    def _fail(self, err: BaseException) -> None:
        with self._cv:
            if not self._error:
                self._error.append(err)
            self._cv.notify_all()

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
