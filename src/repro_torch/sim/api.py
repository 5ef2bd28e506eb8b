"""The user-facing simulation facade.

>>> sim = Simulator.from_config(cfg, scenario=scn)   # on the card
>>> sim.run(5)
>>> state, rec = sim.run(5, recorder=observables.init_recorder(5, nb))
>>> sim.stats()["synapses_formed"]
>>> Simulator.from_config(cfg, num_ranks=4).run(5)   # four ranks, one card

Runs on ``cuda`` unless the caller passes ``device="cpu"``; without a card
and without that argument it raises instead of silently running on the CPU
(``repro_torch.device.resolve_device``, which ``observables.init_recorder``
and ``engine.init_state`` share, so the recorder above lands on the card too).
``run(k)`` is ``k`` sequential ``step()`` calls: all randomness is keyed by
the chunk counter carried in the state and the per-step hash.

Ranks: with ``num_ranks`` R > 1 and no ``comm``, the simulator runs all R
ranks in this process on its one device, each rank's unchanged code in a
thread of its own behind ``dist.LocalComm``'s baton (one rank at a time).
With a ``dist.ProcessGroupComm`` it runs this process's rank of a
``torch.distributed`` group; ``stats()`` and ``health()`` are then
collectives every process must call.
"""
from __future__ import annotations

import functools
from typing import Optional

import torch

from repro_torch import dist
from repro_torch.core import engine
from repro_torch.device import resolve_device
from repro_torch.kernels import _build
from repro_torch.scenarios import observables
from repro_torch.scenarios import protocol as proto
from repro_torch.sim import phases as sim_phases
from repro_torch.telemetry import metrics as telemetry_metrics


class Simulator:
    """Drive the MSP brain simulation on ``num_ranks`` ranks."""

    def __init__(self, cfg, scenario=None, num_ranks: int = 1,
                 device=None, comm: Optional[dist.Comm] = None):
        if comm is not None:
            if num_ranks not in (1, comm.num_ranks):
                raise ValueError(f"Simulator: num_ranks={num_ranks} with a "
                                 f"comm of {comm.num_ranks} ranks")
            num_ranks = comm.num_ranks
        if num_ranks < 1:
            raise ValueError(f"Simulator: num_ranks={num_ranks}")
        self.cfg = cfg
        self.scenario = scenario
        self.num_ranks = num_ranks
        self.comm = comm
        self.device = resolve_device(device)
        self._group = None
        if comm is not None:
            comms = [comm]
        elif num_ranks == 1:
            comms = [dist.SINGLE]
        else:
            self._group = dist.LocalComm(num_ranks)
            comms = [self._group.comm(r) for r in range(num_ranks)]
        # the ranks this process runs, and each one's context
        self.ranks = tuple(c.rank for c in comms)
        self.ctxs = [sim_phases.make_context(cfg, c.rank, num_ranks,
                                             scenario, device=self.device,
                                             comm=c) for c in comms]
        self.ctx = self.ctxs[0]
        self._states: Optional[list] = None
        self._global: Optional[engine.BrainState] = None

    @classmethod
    def from_config(cls, cfg, scenario=None, num_ranks: int = 1,
                    device=None, comm: Optional[dist.Comm] = None
                    ) -> "Simulator":
        return cls(cfg, scenario=scenario, num_ranks=num_ranks, device=device,
                   comm=comm)

    # ------------------------------------------------------------ state
    @property
    def rank_states(self) -> list:
        """The states of the ranks this process runs, in rank order."""
        if self._states is None:
            self.init()
        return self._states

    @property
    def state(self) -> engine.BrainState:
        """The current BrainState; initializes on first access. With ranks
        in this process, the global view (``engine.join_states``: rows
        concatenated in rank order, gid == global row); under a process
        group, this process's rank's state."""
        states = self.rank_states
        if self._global is None:
            self._global = engine.join_states(states)
        return self._global

    @state.setter
    def state(self, value: engine.BrainState) -> None:
        self._set_states([value] if len(self.ranks) == 1
                         else engine.split_state(value, len(self.ranks)))

    def _set_states(self, states: list) -> None:
        self._states = list(states)
        self._global = None

    def init(self) -> engine.BrainState:
        """(Re)initialize from cfg.seed and return the fresh state."""
        self._set_states([engine.init_state(self.cfg, r, self.num_ranks,
                                            self.scenario, device=self.device)
                          for r in self.ranks])
        return self.state

    # ------------------------------------------------------------ driving
    def _advance(self, num_chunks: int) -> None:
        """``num_chunks`` chunks on every rank of this process (one thread
        a rank behind the baton when there are several)."""
        def body(i):
            st = self.rank_states[i]
            for _ in range(num_chunks):
                st = sim_phases.sim_chunk(st, self.ctxs[i])
            return st

        if self._group is None:
            states = [body(0)]
        else:
            states = self._group.run(
                [functools.partial(body, i) for i in range(len(self.ranks))],
                device=self.device)
        self._set_states(states)

    def step(self) -> engine.BrainState:
        """Advance one chunk (Delta activity steps + connectivity update)."""
        self._advance(1)
        return self.state

    def run(self, num_chunks: int, recorder=None):
        """Advance ``num_chunks`` chunks. With ``recorder`` (an
        ``observables.Recorder``) one row of per-region observables is
        recorded on the global state after every chunk and
        ``(state, recorder)`` is returned; without it, the final state."""
        if recorder is None:
            self._advance(int(num_chunks))
            return self.state
        if self.comm is not None and self.num_ranks > 1:
            raise NotImplementedError(
                "recording under a process group (the global arrays live in "
                "several processes): ROADMAP.md Queue 1 item 11")
        if recorder.calcium.device != self.state.positions.device:
            raise ValueError(
                f"run: the recorder lies on {recorder.calcium.device} and "
                f"the simulator on {self.device}; build it with "
                f"observables.init_recorder(..., device=sim.device)")
        for _ in range(int(num_chunks)):
            self._advance(1)
            recorder = self._record(recorder, self.state)
        return self.state, recorder

    def _record(self, rec, st):
        ctx = self.ctx
        # st.chunk has advanced: the global step at this chunk's end
        alive = proto.alive_mask(ctx.events, ctx.regions, st.positions,
                                 st.chunk * self.cfg.rate_period) \
            if ctx.events else None
        return observables.record(rec, st.positions, st.neurons.calcium,
                                  st.neurons.rate, st.out_edges, ctx.regions,
                                  alive)

    # ------------------------------------------------------------ readout
    def _summed(self, values: dict) -> dict:
        """``values`` of the ranks in this process, summed over the process
        group's ranks under a ``ProcessGroupComm`` (a collective)."""
        if self.comm is None or self.num_ranks == 1:
            return values
        keys = sorted(values)
        v = torch.tensor([values[k] for k in keys], dtype=torch.float64)
        if self.device.type == "cuda":
            v = v.to(self.device)
        return dict(zip(keys, self.comm.psum(v).cpu().tolist()))

    def stats(self) -> dict:
        """The device counters summed over ranks, as floats, plus the
        process's kernel launch counts under ``launches/<kernel>``."""
        out = self._summed(telemetry_metrics.reduce_counters(
            [s.stats for s in self.rank_states]))
        out.update({f"launches/{k}": float(v)
                    for k, v in _build.launch_counts().items()})
        return out

    def health(self) -> dict:
        """The health gauges written by the last completed chunk:
        ``health_flags`` (the same on every rank: ``health_verdict`` judges
        the sums over ranks) by max, the census gauges summed over ranks."""
        g = telemetry_metrics.reduce_gauges(
            [s.stats for s in self.rank_states])
        flags = g.pop("health_flags")
        return {"health_flags": flags, **self._summed(g)}
