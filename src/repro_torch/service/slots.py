"""SlotBatch: the device layer of the multi-tenant service, the port's
counterpart of the JAX package's ``repro/service/slots.py``.

A batch holds ``num_slots`` lanes. A *lane* is one tenant's state: the list
of its R rank states, as ``Simulator.rank_states`` holds them (an empty
slot's lane is None). The batch state is the list of the lanes, indexed by
slot. Each lane runs ``phases.sim_chunk`` with contexts of its own,
``dataclasses.replace(template_ctx, cfg=replace(cfg, seed=lane_seed))``:
the population table, regions and events come from one
``phases.make_context`` a rank, and the lane's seed reaches every kernel
(K1 and K2 take the seed and the chunk by value a call, the other phases
read ``ctx.cfg.seed``). So the lowerings may be fused; the JAX service
refuses them, because its Pallas kernels bake the seed in as a static
parameter. A lane's trajectory is bitwise a solo ``Simulator`` run with the
same config and seed: no operation mixes lanes.

Lanes run one after another. At R > 1 one ``dist.LocalComm`` serves the
batch: every rank's thread walks the same lanes in the same order, so the
collectives inside ``sim_chunk`` pair up lane by lane.

``place`` and ``extract`` copy every tensor leaf, the metrics too. The
port's ``Metrics`` are updated in place (``telemetry/metrics.py``), so a
snapshot, a kept final state, or a lane written back from a snapshot that
shared a tensor with a live lane would change under that lane's next
chunk; with copies, no lane, snapshot or final state shares storage with
another.

What differs from the JAX layer: ``step`` advances only the lanes it is
given (the service passes the lanes of RUNNING tenants). The JAX step also
advances free lanes and lanes in backoff, but nothing reads those before
they are written again (an admission places a fresh lane, a retry the
snapshot), so the results are the same with less work. ``probe``,
``health_flags`` and ``observe`` likewise read the lanes they are given
(every lane that holds a state by default) and make one device-to-host
transfer each. ``lane_sharding`` and ``stacked_specs`` describe
``jax.sharding`` layouts and have no counterpart here.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch import dist
from repro_torch.checkpoint import manager
from repro_torch.core import engine
from repro_torch.device import resolve_device
from repro_torch.service.types import ServiceConfigError
from repro_torch.sim import phases as sim_phases


def _copy_lane(lane: list) -> list:
    """A lane whose every tensor leaf is a copy."""
    def copy(_, x):
        return x.clone() if isinstance(x, torch.Tensor) else x
    return [manager.map_leaves(copy, st) for st in lane]


class SlotBatch:
    """The lanes' contexts and the operations on a batch state (the list of
    ``num_slots`` lanes) for one ``BrainConfig`` / scenario template, on
    ``num_ranks`` ranks of this process. Host-side slot bookkeeping lives
    in ``repro_torch.service.service.SimulationService``. On the card unless
    ``device`` names another (``device.resolve_device``)."""

    def __init__(self, cfg, num_slots: int, scenario=None,
                 num_ranks: int = 1, device=None):
        if num_slots < 1:
            raise ServiceConfigError(f"num_slots must be >= 1, "
                                     f"got {num_slots}")
        if num_ranks < 1:
            raise ServiceConfigError(f"num_ranks must be >= 1, "
                                     f"got {num_ranks}")
        self.cfg = cfg
        self.scenario = scenario
        self.num_slots = int(num_slots)
        self.num_ranks = int(num_ranks)
        self.device = resolve_device(device)
        if num_ranks == 1:
            self._group = None
            comms = [dist.SINGLE]
        else:
            self._group = dist.LocalComm(num_ranks)
            comms = [self._group.comm(r) for r in range(num_ranks)]
        self._ctxs = [sim_phases.make_context(cfg, r, num_ranks, scenario,
                                              device=self.device, comm=c)
                      for r, c in enumerate(comms)]
        # lane-chunks run by ``step`` (replays after a rollback included):
        # the unit of the service's work, whose launches it sets
        self.lane_chunks = 0

    # ------------------------------------------------------------ lanes
    def _lane_contexts(self, seed: int) -> list:
        """The R rank contexts of a lane with ``seed``."""
        cfg = dataclasses.replace(self.cfg, seed=int(seed))
        return [dataclasses.replace(c, cfg=cfg) for c in self._ctxs]

    def init_lane(self, seed: int) -> list:
        """A fresh lane: ``engine.init_state`` of every rank under
        ``seed``."""
        cfg = dataclasses.replace(self.cfg, seed=int(seed))
        return [engine.init_state(cfg, r, self.num_ranks, self.scenario,
                                  device=self.device)
                for r in range(self.num_ranks)]

    def init_all(self, seeds: Sequence[int]) -> list:
        """A batch state with a fresh lane in every slot (the JAX layer's
        API; the service admits a lane at a time through ``init_lane``)."""
        if len(seeds) != self.num_slots:
            raise ValueError(f"init_all: {len(seeds)} seeds for "
                             f"{self.num_slots} slots")
        return [self.init_lane(s) for s in seeds]

    def place(self, state: list, lane: list, b: int) -> list:
        """The batch state with a copy of ``lane`` in slot ``b``; the other
        lanes pass through untouched."""
        out = list(state)
        out[b] = _copy_lane(lane)
        return out

    def extract(self, state: list, b: int) -> list:
        """A copy of slot ``b``'s lane."""
        return _copy_lane(state[b])

    # ------------------------------------------------------------ ticking
    def step(self, state: list, seeds, lanes: Sequence[int]) -> list:
        """One chunk of every lane in ``lanes``, in slot order, each under
        the seed ``seeds[b]`` of its slot; the other lanes pass through."""
        lanes = sorted(lanes)
        ctxs = {b: self._lane_contexts(seeds[b]) for b in lanes}

        def body(r):
            return [sim_phases.sim_chunk(state[b][r], ctxs[b][r])
                    for b in lanes]

        per_rank = dist.map_ranks(self._group, self.num_ranks, body,
                                  self.device)
        self.lane_chunks += len(lanes)
        out = list(state)
        for i, b in enumerate(lanes):
            out[b] = [per_rank[r][i] for r in range(self.num_ranks)]
        return out

    # ---------------------------------------------------------- readouts
    def _lanes(self, state: list, lanes: Optional[Sequence[int]]) -> list:
        if lanes is None:
            return [b for b, lane in enumerate(state) if lane is not None]
        return sorted(lanes)

    def _per_slot(self, lanes: list, values: torch.Tensor) -> np.ndarray:
        """(B,) int64 with ``values`` (one transfer) at ``lanes``, 0
        elsewhere."""
        out = np.zeros(self.num_slots, np.int64)
        if lanes:
            out[lanes] = values.cpu().numpy().astype(np.int64)
        return out

    def probe(self, state: list, lanes: Optional[Sequence[int]] = None
              ) -> np.ndarray:
        """Per-slot health bitmask of the CURRENT state: (B,) ints, 0 for
        the slots not probed. The gauges only hold the last completed
        chunk's verdict; this runs ``health_verdict`` on the state as it is
        now, into copies of the gauges (as ``Simulator.probe_health``), so a
        probe writes nothing into a lane."""
        lanes = self._lanes(state, lanes)
        if not lanes:
            return np.zeros(self.num_slots, np.int64)

        def body(r):
            return torch.cat([sim_phases.probe_flags(state[b][r],
                                                     self._ctxs[r])
                              for b in lanes])

        flags = torch.stack(dist.map_ranks(self._group, self.num_ranks,
                                            body, self.device)).amax(0)
        return self._per_slot(lanes, flags)

    def health_flags(self, state: list,
                     lanes: Optional[Sequence[int]] = None) -> np.ndarray:
        """Per-slot health bitmask written by the last completed chunk (the
        in-chunk verdict), max over ranks: (B,) ints."""
        lanes = self._lanes(state, lanes)
        if not lanes:
            return np.zeros(self.num_slots, np.int64)
        g = torch.stack([torch.cat([st.stats.gauges["health_flags"]
                                    for st in state[b]]) for b in lanes])
        return self._per_slot(lanes, g.amax(1))

    def chunks(self, state: list) -> np.ndarray:
        """Per-slot chunk counters: (B,) ints (host counters, no
        transfer; 0 for an empty slot)."""
        return np.array([lane[0].chunk if lane is not None else 0
                         for lane in state], np.int64)

    def counters(self, state: list, b: Optional[int] = None):
        """Device counters summed over ranks: a dict of (B,) arrays (0 for
        an empty slot), or of floats for one slot when ``b`` is given. One
        transfer."""
        lanes = self._lanes(state, None if b is None else [b])
        if not lanes:
            return {}
        keys = list(state[lanes[0]][0].stats.counters)
        c = torch.stack([torch.stack([
            torch.cat([st.stats.counters[k] for st in state[x]]).sum()
            for k in keys]) for x in lanes]).cpu().numpy()   # (L, K)
        if b is not None:
            return {k: float(v) for k, v in zip(keys, c[0])}
        out = np.zeros((self.num_slots, len(keys)), np.float32)
        out[lanes] = c
        return {k: out[:, i] for i, k in enumerate(keys)}

    def observe(self, state: list, lanes: Optional[Sequence[int]] = None
                ) -> np.ndarray:
        """(B, 4) observable rows (chunk, mean rate, mean calcium, live
        out-edges) over each lane's global rows, 0 for the slots not read.
        One transfer."""
        out = np.zeros((self.num_slots, 4), np.float32)
        lanes = self._lanes(state, lanes)
        if not lanes:
            return out
        f32 = torch.float32
        rows = []
        for b in lanes:
            parts = torch.stack([torch.stack([
                st.neurons.rate.sum(), st.neurons.calcium.sum(),
                (st.out_edges >= 0).sum().to(f32)]) for st in state[b]])
            tot = parts.sum(0)
            n = sum(st.neurons.rate.shape[0] for st in state[b])
            rows.append(torch.stack([tot[0] / n, tot[1] / n, tot[2]]))
        host = torch.stack(rows).cpu().numpy()
        out[lanes, 0] = [state[b][0].chunk for b in lanes]
        out[lanes, 1:] = host
        return out

