"""The user-facing simulation facade.

>>> sim = Simulator.from_config(cfg, scenario=scn)   # on the card
>>> sim.run(5)
>>> state, rec = sim.run(5, recorder=observables.init_recorder(5, nb))
>>> sim.stats()["synapses_formed"]
>>> Simulator.from_config(cfg, num_ranks=4).run(5)   # four ranks, one card
>>> sim = Simulator.from_connectome(cfg, dataset)    # a loaded connectome
>>> sim.step_with(phases.DynamicParams.zeros(nb))    # a drive per region
>>> step = sim.save(ckpt_dir); sim.restore(ckpt_dir)  # the JAX layout

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
``torch.distributed`` group; ``stats()``, ``health()``, ``metrics()``,
``probe_health()``, ``save``, ``restore`` and a ``run`` with a recorder are
then collectives every process must call (``save`` all-gathers the ranks'
rows into the JAX package's global layout, and rank 0 writes).

Checkpoints (``save`` / ``restore``, through ``repro_torch.checkpoint
.manager``) hold the global state in the JAX package's layout, so the two
packages restore each other's. The host-side lifecycle counters
(``telemetry.metrics.LIFECYCLE_KEYS``) live on the simulator; the runner
(``runtime.sim_runner``) keeps them, ``stats()`` reports them.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch import dist, telemetry
from repro_torch.checkpoint import manager
from repro_torch.connectome import routing
from repro_torch.core import engine
from repro_torch.core import spikes
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
        with telemetry.span("sim.construct", ranks=num_ranks,
                            n=cfg.neurons_per_rank):
            self.ctxs = [sim_phases.make_context(cfg, c.rank, num_ranks,
                                                 scenario, device=self.device,
                                                 comm=c) for c in comms]
        self.ctx = self.ctxs[0]
        self._states: Optional[list] = None
        self._global: Optional[engine.BrainState] = None
        self._dyn_signatures: set = set()
        # the ranks' rows live in several processes
        self._spread = comm is not None and num_ranks > 1
        # host-side runner lifecycle counters, merged into stats() and kept
        # jointly with runtime.sim_runner.SimulationRunner
        self.lifecycle = {k: 0 for k in telemetry_metrics.LIFECYCLE_KEYS}

    @classmethod
    def from_config(cls, cfg, scenario=None, num_ranks: int = 1,
                    device=None, comm: Optional[dist.Comm] = None
                    ) -> "Simulator":
        return cls(cfg, scenario=scenario, num_ranks=num_ranks, device=device,
                   comm=comm)

    @classmethod
    def from_connectome(cls, cfg, dataset, scenario=None, num_ranks: int = 1,
                        device=None, comm: Optional[dist.Comm] = None
                        ) -> "Simulator":
        """A Simulator whose initial state is wired from a
        ``workloads.datasets.ConnectomeDataset`` instead of empty tables.

        Checked before anything is built: the dataset's structure, its row
        count against ``num_ranks * cfg.neurons_per_rank`` (gid == global
        row) and its excitation layout against the (cfg, scenario)
        population table of every rank block; no degree may exceed
        ``cfg.max_synapses``. Under the sparse exchange the subscription
        registry is sized from the measured per-rank count of unique remote
        sources (baked into ``cfg.subs_cap_base``) and derived through
        ``rebuild_exchange``, the exchange's own computation, so sparse ==
        dense holds from the first chunk."""
        from repro_torch.workloads import datasets as wds
        wds.validate(dataset)
        ranks = comm.num_ranks if comm is not None else num_ranks
        n = cfg.neurons_per_rank
        if dataset.num_neurons != ranks * n:
            raise ValueError(
                f"dataset {dataset.name!r} has {dataset.num_neurons} "
                f"neurons; need num_ranks*neurons_per_rank = "
                f"{ranks}*{n} = {ranks * n} (gid == global row)")
        wds.check_population_layout(dataset, cfg, scenario, ranks)
        if cfg.rate_exchange == "sparse" and cfg.subs_cap_base is None:
            cfg = dataclasses.replace(
                cfg, subs_cap_base=wds.max_unique_remote_sources(dataset, n))
        sim = cls(cfg, scenario=scenario, num_ranks=num_ranks, device=device,
                  comm=comm)
        sim._install_connectome(dataset)
        return sim

    def _install_connectome(self, dataset) -> None:
        """Overwrite the fresh state's connectivity with the dataset, rank
        r taking rows [r n, (r + 1) n): positions, the front-packed out and
        in edge tables, the excitation, and element counts covering the
        wired degrees (each neuron keeps its seeded vacant draw on top, so
        the first update grows from the loaded connectome rather than
        retracting it). Under a process group each process installs its
        own rank's block."""
        from repro_torch.workloads import datasets as wds
        n = self.cfg.neurons_per_rank
        dev = self.device
        with telemetry.span("sim.from_connectome",
                            neurons=dataset.num_neurons,
                            edges=dataset.num_edges):
            out_e, in_e = wds.edge_tables(dataset, self.cfg.max_synapses)

            def block(x, r):
                return torch.from_numpy(
                    np.ascontiguousarray(x[r * n:(r + 1) * n])).to(dev)

            states = []
            for r, st in zip(self.ranks, self.rank_states):
                out_deg = (out_e[r * n:(r + 1) * n] >= 0).sum(1).astype(
                    np.float32)
                in_deg = (in_e[r * n:(r + 1) * n] >= 0).sum(1).astype(
                    np.float32)
                neurons = st.neurons._replace(
                    ax_elements=st.neurons.ax_elements
                    + torch.from_numpy(out_deg).to(dev),
                    de_elements=st.neurons.de_elements
                    + torch.from_numpy(in_deg).to(dev),
                    is_excitatory=block(dataset.is_excitatory, r))
                states.append(st._replace(
                    neurons=neurons, positions=block(dataset.positions, r),
                    out_edges=block(out_e, r), in_edges=block(in_e, r)))
            self._set_states(states)
            # subs, rate_slots and remote_rates from the installed in-edge
            # table (the rates are all zero, so the pushed buffer matches
            # the dense table's zeros bit for bit)
            self.rebuild_exchange()

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

    @property
    def chunk(self) -> int:
        """The chunks completed (the same on every rank)."""
        return self.rank_states[0].chunk

    @property
    def is_writer(self) -> bool:
        """Whether this process writes the checkpoints and the heartbeat:
        rank 0 under a process group, else always."""
        return self.comm is None or self.comm.rank == 0

    def barrier(self) -> None:
        """Wait for every process of the group (a psum); nothing without a
        process group."""
        if self.comm is not None:
            float(self.comm.psum(torch.zeros(1, device=self.device)))

    def _gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's rows of ``x`` in rank order (an all-gather; bool
        leaves travel as uint8, which gloo takes)."""
        if x.dtype == torch.bool:
            return self.comm.all_gather(x.view(torch.uint8)).view(torch.bool)
        return self.comm.all_gather(x)

    def global_state(self) -> engine.BrainState:
        """The global state in every process: ``state``, or under a process
        group every rank's rows all-gathered (a collective)."""
        if not self._spread:
            return self.state
        return engine.map_rank_rows(self.state, self._gather)

    def _template(self) -> engine.BrainState:
        """The global state's keys, shapes and dtypes without its data: the
        current state's leaves as ``meta`` tensors, the ranks' rows joined
        (under a process group, this rank's rows times the rank count)."""
        def meta(_, x):
            return torch.empty_like(x, device="meta") \
                if isinstance(x, torch.Tensor) else x

        states = [manager.map_leaves(meta, s) for s in self.rank_states]
        if self._spread:
            return engine.map_rank_rows(states[0], lambda x: x.new_empty(
                (self.num_ranks * x.shape[0],) + tuple(x.shape[1:])))
        return engine.join_states(states)

    def _install(self, host: engine.BrainState) -> None:
        """Take a global state held on the host (CPU tensors, e.g. from
        ``manager.restore``): each rank of this process its rows (and a
        copy of the replicated rates table), each leaf put on the device
        with ``non_blocking=True`` (no wait for the stream)."""
        num_ranks = self.num_ranks

        def put(_, x):
            return x.to(self.device, non_blocking=True) \
                if isinstance(x, torch.Tensor) else x

        states = []
        for r in self.ranks:
            def rows(x, r=r):
                m = x.shape[0] // num_ranks
                return x[r * m:(r + 1) * m]
            st = engine.map_rank_rows(host, rows)
            if st.rates_table is not None:
                st = st._replace(rates_table=st.rates_table.clone())
            states.append(manager.map_leaves(put, st))
        self._set_states(states)

    def init(self) -> engine.BrainState:
        """(Re)initialize from cfg.seed and return the fresh state."""
        with telemetry.span("sim.init"):
            self._set_states([engine.init_state(self.cfg, r, self.num_ranks,
                                                self.scenario,
                                                device=self.device)
                              for r in self.ranks])
        return self.state

    # ------------------------------------------------------------ driving
    def _map_ranks(self, body) -> list:
        """``[body(i)]`` for the i-th rank of this process, on every rank
        (one thread a rank behind the baton when there are several)."""
        return dist.map_ranks(self._group, len(self.ranks), body,
                              self.device)

    def _on_ranks(self, body) -> None:
        """``body(i)`` -> the new state of the i-th rank of this process."""
        self._set_states(self._map_ranks(body))

    def _advance(self, num_chunks: int, ctxs=None) -> None:
        """``num_chunks`` chunks on every rank of this process."""
        ctxs = self.ctxs if ctxs is None else ctxs

        def body(i):
            st = self.rank_states[i]
            for _ in range(num_chunks):
                st = sim_phases.sim_chunk(st, ctxs[i])
            return st

        self._on_ranks(body)

    def step(self) -> engine.BrainState:
        """Advance one chunk (Delta activity steps + connectivity update)."""
        with telemetry.span("sim.step"):
            self._advance(1)
        return self.state

    def step_with(self, dyn) -> engine.BrainState:
        """Advance one chunk with the ``phases.DynamicParams`` ``dyn`` on
        every rank's context. The host may change the values between
        chunks: they reach the kernels by pointer, nothing is rebuilt. A
        leaf that is not a tensor on the simulator's device goes up with
        ``non_blocking=True`` (no wait for the stream)."""
        dyn = sim_phases.DynamicParams(*(
            torch.as_tensor(x, dtype=torch.float32).to(
                self.device, non_blocking=True)
            if not isinstance(x, torch.Tensor) or x.device != self.device
            else x for x in dyn))
        self._dyn_signatures.add(tuple(
            (tuple(x.shape), x.dtype, x.device) for x in dyn))
        with telemetry.span("sim.step_with"):
            self._advance(1, [dataclasses.replace(c, dyn=dyn)
                              for c in self.ctxs])
        return self.state

    def dyn_compile_count(self) -> int:
        """The distinct (shape, dtype, device) signatures of the
        ``DynamicParams`` leaves ``step_with`` has run: the reference's
        retrace key (it counts jit traces; the port compiles nothing per
        call). The assimilation loop asserts it stays 1."""
        return len(self._dyn_signatures)

    def rebuild_exchange(self) -> engine.BrainState:
        """Re-derive the sparse exchange's fields (the subscription
        registry, the edge -> slot remap, the subscribed-rate buffer) from
        the in-edge table and the rates: the computation ``exchange_sparse``
        runs at every chunk's end, on every rank (a collective under a
        process group). No-op under the dense exchange."""
        if self.cfg.rate_exchange != "sparse":
            return self.state
        cfg, n = self.cfg, self.cfg.neurons_per_rank
        cap = routing.cap_subs(cfg, self.num_ranks)

        def body(i):
            st, ctx = self.rank_states[i], self.ctxs[i]
            subs, rate_slots, _ = spikes.build_subscriptions(
                st.in_edges, ctx.rank, n, cap)
            remote_rates, _ = routing.push_subscribed_rates(
                subs, st.neurons.rate, ctx.comm, n)
            return st._replace(subs=subs, rate_slots=rate_slots,
                               remote_rates=remote_rates)

        with telemetry.span("sim.rebuild_exchange"):
            self._on_ranks(body)
        return self.state

    def run(self, num_chunks: int, recorder=None):
        """Advance ``num_chunks`` chunks. With ``recorder`` (an
        ``observables.Recorder``) one row of per-region observables is
        recorded on the global state after every chunk and
        ``(state, recorder)`` is returned; without it, the final state."""
        state = self.state   # init outside the span
        if recorder is not None and \
                recorder.calcium.device != state.positions.device:
            raise ValueError(
                f"run: the recorder lies on {recorder.calcium.device} and "
                f"the simulator on {self.device}; build it with "
                f"observables.init_recorder(..., device=sim.device)")
        with telemetry.span("sim.run", chunks=int(num_chunks)):
            if recorder is None:
                self._advance(int(num_chunks))
                return self.state
            for _ in range(int(num_chunks)):
                self._advance(1)
                recorder = self._record(recorder, self._record_view())
        return self.state, recorder

    def _record_view(self) -> engine.BrainState:
        """The global arrays the recorder reads: ``state``, or under a
        process group this rank's state with the four of them (positions,
        calcium, rate, out_edges) all-gathered, so every process records
        the rows the ranks in one process would."""
        st = self.state
        if not self._spread:
            return st
        g = self._gather
        return st._replace(
            positions=g(st.positions), out_edges=g(st.out_edges),
            neurons=st.neurons._replace(calcium=g(st.neurons.calcium),
                                        rate=g(st.neurons.rate)))

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

    def stats(self, reduce: bool = True) -> dict:
        """The device counters summed over ranks, as floats, plus the
        host-side lifecycle counters and the process's kernel launch counts
        under ``launches/<kernel>``. ``reduce=False``: the device counters
        only, each the (R,) host array of the ranks' values."""
        if not reduce:
            return dict(self.metrics().counters)
        out = self._summed(telemetry_metrics.reduce_counters(
            [s.stats for s in self.rank_states]))
        out.update({k: float(v) for k, v in self.lifecycle.items()})
        out.update({f"launches/{k}": float(v)
                    for k, v in _build.launch_counts().items()})
        return out

    def metrics(self) -> telemetry_metrics.Metrics:
        """The global metrics tree (counters, per-chunk rings, histograms,
        gauges) with numpy leaves, the leading axis the ranks: one transfer
        a leaf of the joined tree (under a process group, all-gathered)."""
        with telemetry.span("sim.metrics"):
            if self._spread:
                m = telemetry_metrics.map_leaves(self.state.stats,
                                                 self._gather)
            else:
                m = telemetry_metrics.join([s.stats
                                            for s in self.rank_states])
            return telemetry_metrics.map_leaves(
                m, lambda x: x.cpu().numpy())

    def health(self) -> dict:
        """The health gauges written by the last completed chunk:
        ``health_flags`` (the same on every rank: ``health_verdict`` judges
        the sums over ranks) by max, the census gauges summed over ranks."""
        g = telemetry_metrics.reduce_gauges(
            [s.stats for s in self.rank_states])
        flags = g.pop("health_flags")
        return {"health_flags": flags, **self._summed(g)}

    def probe_health(self) -> int:
        """The health verdict (``phases.health_verdict``, the computation
        that closes every chunk) on the current state, as the global
        ``health_flags`` bitmask; on every rank, behind the baton (the
        verdict psums). The state is left as it was: the verdict writes
        into copies of the gauges, so ``health()``, ``stats()`` and the
        next checkpoint see the last chunk's."""
        def body(i):
            return sim_phases.probe_flags(self.rank_states[i], self.ctxs[i])

        with telemetry.span("sim.probe_health"):
            flags = self._map_ranks(body)
        return int(flags[0].item())

    # ------------------------------------------------------------ persist
    def ckpt_metadata(self) -> dict:
        """Checkpoint metadata: enough for a fresh process (maybe on
        another rank count or after a degrade) to decide how to restore
        (``runtime.sim_runner.try_resume``, ``runtime.elastic``)."""
        return {"cfg": self.cfg.name,
                "rate_exchange": self.cfg.rate_exchange,
                "num_ranks": self.num_ranks,
                "neurons_per_rank": self.cfg.neurons_per_rank,
                "subs_cap_factor": self.cfg.subs_cap_factor,
                "subs_cap_base": self.cfg.subs_cap_base,
                "requests_cap_factor": self.cfg.requests_cap_factor,
                "lifecycle": dict(self.lifecycle)}

    def save(self, path: str) -> int:
        """Atomic full-state checkpoint at ``<path>/step_<chunk>/`` in the
        JAX package's layout (``checkpoint.manager``). Under a process
        group the ranks' rows are all-gathered, rank 0 writes and every
        process waits for the rename. Returns the saved chunk number."""
        with telemetry.span("sim.save", step=self.chunk):
            st = self.global_state()
            if self.is_writer:
                manager.save(path, st.chunk, st,
                             metadata=self.ckpt_metadata())
            self.barrier()
        self.lifecycle["checkpoint_saves"] += 1
        return st.chunk

    def restore(self, path: str, step: Optional[int] = None) -> int:
        """Load a checkpoint (the latest step by default; FileNotFoundError
        if there is none) and give each rank of this process its rows on
        ``self.device``. ``run`` then continues bitwise as an uninterrupted
        run: every draw is keyed by the restored chunk counter, and the
        metrics travel with the state. Under a process group every process
        reads the files and keeps its own rows."""
        if step is None:
            step = manager.latest_step(path)
            if step is None:
                raise FileNotFoundError(f"no checkpoint under {path!r}")
        with telemetry.span("sim.restore", step=step):
            host, _ = manager.restore(path, step, self._template())
            self._install(host)
        self.lifecycle["checkpoint_restores"] += 1
        return step
