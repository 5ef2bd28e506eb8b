"""Rate assimilation: steer per-region activity onto a target trace. The
port's copy of the JAX package's ``repro/workloads/assimilate.py``.

A host-driven closed loop around ``Simulator.step_with``: after every chunk
the host reads the per-region mean rate (one small transfer, the loop's one
wait a chunk), updates an integral controller, and feeds the corrected
per-region drive offsets back in through ``phases.DynamicParams``: a host
array that ``step_with`` sends up without a wait (``non_blocking=True``)
and whose values the kernels read by pointer, so nothing is rebuilt and ``AssimilationResult.compile_count``
(``Simulator.dyn_compile_count``) stays 1.

Targets are a ``(T, nb)`` array over the scenario's region buckets
(``assign_regions`` order, trailing 'rest' bucket); ``NaN`` marks a bucket
the controller leaves alone (drive 0). Chaos hooks (e.g.
``runtime.chaos.drop_region_input``) fire before every chunk and may call
``loop.drop(region, chunks)`` to zero a region's external drive; the
controller must then wind the drive back up.

    python -m repro_torch.workloads.assimilate --smoke --device cpu
"""
from __future__ import annotations

import dataclasses
import json
from typing import Optional, Sequence, Tuple

import numpy as np

from repro_torch import telemetry
from repro_torch.configs.msp_brain import SMOKE_CONFIG, BrainConfig
from repro_torch.scenarios.protocol import Scenario
from repro_torch.scenarios.regions import Region, assign_regions, num_buckets
from repro_torch.sim import phases as sim_phases
from repro_torch.sim.api import Simulator


@dataclasses.dataclass
class AssimilationResult:
    target: np.ndarray        # (T, nb) the requested trace (NaN = free)
    measured: np.ndarray      # (T, nb) per-bucket mean rate after each chunk
    drive: np.ndarray         # (T, nb) the offsets that produced row t
    abs_err: np.ndarray       # (T,) mean |target - measured| over controlled
    compile_count: int        # must be 1: one DynamicParams signature

    @property
    def final_abs_err(self) -> float:
        return float(self.abs_err[-1])


class AssimilationLoop:
    """Integral controller nudging each controlled region bucket's mean
    rate toward ``target[t]`` chunk by chunk.

    ``gain`` is in drive units per rate unit (background drive is ~5.0,
    rates ~0.01 a step); ``clip`` bounds the accumulated offset so a dead
    region cannot wind the integrator up without bound."""

    def __init__(self, sim: Simulator, target, gain: float = 120.0,
                 clip: float = 4.0, hooks: Sequence = ()):
        if sim.scenario is None or not sim.scenario.regions:
            raise ValueError("AssimilationLoop needs a scenario with "
                             "named regions (the control buckets)")
        self.sim = sim
        self.regions = sim.scenario.regions
        self.nb = num_buckets(self.regions)
        self.target = np.asarray(target, np.float32)
        if self.target.ndim != 2 or self.target.shape[1] != self.nb:
            raise ValueError(
                f"target must be (chunks, {self.nb}) — one column per "
                f"region bucket incl. the trailing 'rest'; got "
                f"{self.target.shape}")
        self.gain = float(gain)
        self.clip = float(clip)
        self.hooks = list(hooks)
        self.chunk_index = 0
        self._drive = np.zeros((self.nb,), np.float32)
        self._drop_left = np.zeros((self.nb,), np.int64)
        # positions never change: resolve bucket membership once
        rid = assign_regions(sim.state.positions, self.regions)
        self._rid = rid.cpu().numpy()
        self._counts = np.maximum(np.bincount(self._rid, minlength=self.nb),
                                  1).astype(np.float32)

    def _bucket(self, region) -> int:
        name = region.name if isinstance(region, Region) else region
        for i, r in enumerate(self.regions):
            if r.name == name:
                return i
        raise KeyError(f"unknown region {name!r}; "
                       f"have {[r.name for r in self.regions]}")

    def drop(self, region, chunks: int) -> None:
        """Zero ``region``'s external drive for the next ``chunks`` chunks
        (the chaos injection surface, ``chaos.drop_region_input``)."""
        b = self._bucket(region)
        self._drop_left[b] = max(self._drop_left[b], int(chunks))

    def measured_rates(self) -> np.ndarray:
        """(nb,) per-bucket mean rate of the current state."""
        rate = self.sim.state.neurons.rate.cpu().numpy()
        return (np.bincount(self._rid, weights=rate, minlength=self.nb)
                / self._counts).astype(np.float32)

    def run(self) -> AssimilationResult:
        T = self.target.shape[0]
        controlled = ~np.isnan(self.target)
        measured = np.zeros((T, self.nb), np.float32)
        drives = np.zeros((T, self.nb), np.float32)
        abs_err = np.zeros((T,), np.float32)
        bg = self.sim.cfg.background_mean
        with telemetry.span("workloads.assimilate", chunks=T, nb=self.nb):
            for t in range(T):
                self.chunk_index = t
                for hook in self.hooks:
                    hook(self)
                applied = self._drive.copy()
                dropped = self._drop_left > 0
                # a dropped region's mean external drive is cancelled
                # outright (controller offset included)
                applied[dropped] = -bg
                drives[t] = applied
                self.sim.step_with(sim_phases.DynamicParams(
                    region_drive=applied))
                measured[t] = self.measured_rates()
                err = np.where(controlled[t],
                               np.nan_to_num(self.target[t]) - measured[t],
                               0.0)
                abs_err[t] = (np.abs(err).sum()
                              / max(controlled[t].sum(), 1))
                # integrate only where not dropped: winding up against a
                # zeroed input would overshoot on recovery
                self._drive = np.clip(
                    self._drive + self.gain * np.where(dropped, 0.0, err),
                    -self.clip, self.clip).astype(np.float32)
                self._drop_left = np.maximum(self._drop_left - 1, 0)
        return AssimilationResult(
            target=self.target, measured=measured, drive=drives,
            abs_err=abs_err, compile_count=self.sim.dyn_compile_count())


def constant_target(chunks: int, nb: int, bucket: int,
                    value: float) -> np.ndarray:
    """(chunks, nb) trace holding ``bucket`` at ``value``, every other
    bucket free (NaN)."""
    t = np.full((chunks, nb), np.nan, np.float32)
    t[:, bucket] = value
    return t


def default_scenario() -> Scenario:
    """One controlled region (the left half-sheet) and the free rest."""
    return Scenario(
        name="assimilation",
        regions=(Region("driven", lo=(0.0, 0.0, 0.0), hi=(0.5, 1.0, 1.0)),),
        num_chunks=12)


def run_assimilation(cfg: Optional[BrainConfig] = None, chunks: int = 12,
                     target_rate: float = 0.02, gain: float = 120.0,
                     hooks: Sequence = (), num_ranks: int = 1, device=None,
                     comm=None) -> Tuple[AssimilationResult, Simulator]:
    """Build the default one-region experiment and run it (on the card
    unless ``device`` names another)."""
    cfg = cfg or dataclasses.replace(SMOKE_CONFIG, requests_cap_factor=1000)
    scn = default_scenario()
    sim = Simulator.from_config(cfg, scenario=scn, num_ranks=num_ranks,
                                device=device, comm=comm)
    target = constant_target(chunks, num_buckets(scn.regions), 0,
                             target_rate)
    loop = AssimilationLoop(sim, target, gain=gain, hooks=hooks)
    return loop.run(), sim


def main(argv=None) -> dict:
    import argparse
    p = argparse.ArgumentParser(description="rate-assimilation workload")
    p.add_argument("--smoke", action="store_true",
                   help="smoke scale (64 neurons/rank)")
    p.add_argument("--chunks", type=int, default=12)
    p.add_argument("--target-rate", type=float, default=0.02)
    p.add_argument("--device", default=None,
                   help="torch device (default: the card)")
    args = p.parse_args(argv)
    cfg = dataclasses.replace(SMOKE_CONFIG, requests_cap_factor=1000)
    if not args.smoke:
        cfg = dataclasses.replace(cfg, neurons_per_rank=256)
    res, _ = run_assimilation(cfg, chunks=args.chunks,
                              target_rate=args.target_rate,
                              device=args.device)
    out = {"assim_final_abs_err": res.final_abs_err,
           "assim_first_abs_err": float(res.abs_err[0]),
           "dyn_compile_count": float(res.compile_count),
           "chunks": float(args.chunks)}
    assert res.compile_count == 1, \
        f"dynamic params changed signature: {res.compile_count} signatures"
    print(json.dumps(out, indent=2, sort_keys=True))
    return out


if __name__ == "__main__":
    main()
