"""The user-facing simulation facade.

>>> sim = Simulator.from_config(cfg, scenario=scn)   # on the card
>>> sim.run(5)
>>> state, rec = sim.run(5, recorder=observables.init_recorder(5, nb))
>>> sim.stats()["synapses_formed"]

Runs on ``cuda`` unless the caller passes ``device="cpu"``; without a card
and without that argument it raises instead of silently running on the CPU
(``repro_torch.device.resolve_device``, which ``observables.init_recorder``
and ``engine.init_state`` share, so the recorder above lands on the card too).
``run(k)`` is ``k`` sequential ``step()`` calls: all randomness is keyed by
the chunk counter carried in the state and the per-step hash.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.core import engine
from repro_torch.device import resolve_device
from repro_torch.kernels import _build
from repro_torch.scenarios import observables
from repro_torch.scenarios import protocol as proto
from repro_torch.sim import phases as sim_phases
from repro_torch.sim import registry


class Simulator:
    """Drive the MSP brain simulation on one rank."""

    def __init__(self, cfg, scenario=None, num_ranks: int = 1,
                 device=None):
        if num_ranks != 1:
            raise NotImplementedError(
                "multi-rank simulation: ROADMAP.md Queue 1 item 8")
        # every selected lowering must exist in the port (raises
        # NotImplementedError naming the ROADMAP item otherwise)
        for domain, field in registry.CONFIG_FIELDS.items():
            registry.resolve(domain, getattr(cfg, field))
        self.cfg = cfg
        self.scenario = scenario
        self.num_ranks = num_ranks
        self.device = resolve_device(device)
        self.ctx = sim_phases.make_context(cfg, 0, num_ranks, scenario,
                                           device=self.device)
        self._state: Optional[engine.BrainState] = None

    @classmethod
    def from_config(cls, cfg, scenario=None, num_ranks: int = 1,
                    device=None) -> "Simulator":
        return cls(cfg, scenario=scenario, num_ranks=num_ranks, device=device)

    # ------------------------------------------------------------ state
    @property
    def state(self) -> engine.BrainState:
        """The current BrainState; initializes on first access."""
        if self._state is None:
            self.init()
        return self._state

    @state.setter
    def state(self, value: engine.BrainState) -> None:
        self._state = value

    def init(self) -> engine.BrainState:
        """(Re)initialize from cfg.seed and return the fresh state."""
        self._state = engine.init_state(self.cfg, 0, self.num_ranks,
                                        self.scenario, device=self.device)
        return self._state

    # ------------------------------------------------------------ driving
    def step(self) -> engine.BrainState:
        """Advance one chunk (Delta activity steps + connectivity update)."""
        self._state = sim_phases.sim_chunk(self.state, self.ctx)
        return self._state

    def run(self, num_chunks: int, recorder=None):
        """Advance ``num_chunks`` chunks. With ``recorder`` (an
        ``observables.Recorder``) one row of per-region observables is
        recorded after every chunk and ``(state, recorder)`` is returned;
        without it, the final state."""
        if recorder is not None and \
                recorder.calcium.device != self.state.positions.device:
            raise ValueError(
                f"run: the recorder lies on {recorder.calcium.device} and "
                f"the simulator on {self.device}; build it with "
                f"observables.init_recorder(..., device=sim.device)")
        for _ in range(int(num_chunks)):
            st = self.step()
            if recorder is not None:
                recorder = self._record(recorder, st)
        return self.state if recorder is None else (self.state, recorder)

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
    def stats(self) -> dict:
        """The device counters as floats, plus the process's kernel launch
        counts under ``launches/<kernel>``."""
        counters = self.state.stats.counters
        out = {k: float(v.sum()) for k, v in counters.items()}
        out.update({f"launches/{k}": float(v)
                    for k, v in _build.launch_counts().items()})
        return out

    def health(self) -> dict:
        """The health gauges written by the last completed chunk."""
        return {k: float(v.max() if k == "health_flags" else v.sum())
                for k, v in self.state.stats.gauges.items()}
