"""Declarative stimulus/lesion protocols (the port's copy of the JAX
package's ``scenarios/protocol.py``).

A protocol is a tuple of events over *global* step time (1 step = 1 ms,
rate_period steps per chunk). The event meta stays a host tuple; the region
masks are tensors on the positions' device.

  Stimulate(region, amplitude, t0, t1)  extra input current ``amplitude``
      to every neuron in ``region`` for steps t0 <= t < t1.
  Lesion(region, t)  neurons in ``region`` die at step t: no spikes, zero
      advertised rate, synaptic elements forced to zero (which retracts all
      their synapses at the next connectivity update and notifies partners),
      excluded from Barnes-Hut search and from accepting new synapses.
  Recover(region, t)  the region's neurons come back online at step t.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence, Tuple

import torch

from repro_torch.scenarios.regions import Region, region_mask

_NEVER = 1 << 30   # "end of time" for lesions without a matching Recover


@dataclass(frozen=True)
class Stimulate:
    region: str
    amplitude: float
    t0: int
    t1: int


@dataclass(frozen=True)
class Lesion:
    region: str
    t: int


@dataclass(frozen=True)
class Recover:
    region: str
    t: int


@dataclass(frozen=True)
class Scenario:
    """A runnable experiment: who the neurons are (populations), where they
    live (regions), and what happens to them (events)."""
    name: str
    populations: Tuple = ()     # () -> BrainConfig-default populations
    regions: Tuple[Region, ...] = ()
    events: Tuple = ()
    num_chunks: int = 20        # suggested run length (chunks of rate_period)


def _region(regions: Sequence[Region], name: str) -> Region:
    for r in regions:
        if r.name == name:
            return r
    raise KeyError(f"protocol references unknown region {name!r}; "
                   f"have {[r.name for r in regions]}")


def has_lesions(scenario) -> bool:
    return scenario is not None and any(
        isinstance(e, Lesion) for e in scenario.events)


def stim_drive(events, regions: Sequence[Region], positions, step: int):
    """(n,) extra input current at global ``step``; a 0-d zero when the
    protocol has no stimulation events."""
    drive = torch.zeros((), dtype=torch.float32, device=positions.device)
    for ev in events:
        if not isinstance(ev, Stimulate):
            continue
        mask = region_mask(positions, _region(regions, ev.region))
        active = torch.tensor(float(ev.t0 <= step < ev.t1),
                              dtype=torch.float32, device=positions.device)
        drive = drive + ev.amplitude * active * mask.to(torch.float32)
    return drive


def _lesion_windows(events, regions: Sequence[Region]):
    """Per Lesion event: (region, t_dead, t_recover). A Recover for the same
    region at a later time closes the window (earliest such Recover wins)."""
    windows = []
    for ev in events:
        if not isinstance(ev, Lesion):
            continue
        t1 = min((r.t for r in events
                  if isinstance(r, Recover) and r.region == ev.region
                  and r.t > ev.t), default=_NEVER)
        windows.append((_region(regions, ev.region), ev.t, t1))
    return windows


def stim_tables(events, regions: Sequence[Region], positions):
    """Stimulate events as activity-window operands: ``((E, n) f32 region
    masks, ((amplitude, t0, t1), ...))``; the step adds ``amplitude *
    (t0 <= gstep < t1) * mask`` per event. None when nothing stimulates."""
    evs = [e for e in events if isinstance(e, Stimulate)]
    if not evs:
        return None
    masks = torch.stack([
        region_mask(positions, _region(regions, e.region)).to(torch.float32)
        for e in evs])
    meta = tuple((float(e.amplitude), int(e.t0), int(e.t1)) for e in evs)
    return masks, meta


def lesion_tables(events, regions: Sequence[Region], positions):
    """Lesion windows as activity-window operands: ``((W, n) bool region
    masks, ((t_dead, t_recover), ...))``. None when nothing lesions."""
    windows = _lesion_windows(events, regions)
    if not windows:
        return None
    masks = torch.stack([region_mask(positions, r) for r, _, _ in windows])
    meta = tuple((int(t0), int(t1)) for _, t0, t1 in windows)
    return masks, meta


def alive_mask(events, regions: Sequence[Region], positions, step: int):
    """(n,) bool at global ``step``: False while inside any lesion window.
    None when the protocol never lesions."""
    windows = _lesion_windows(events, regions)
    if not windows:
        return None
    alive = torch.ones(positions.shape[0], dtype=torch.bool,
                       device=positions.device)
    for region, t0, t1 in windows:
        if t0 <= step < t1:
            alive = alive & ~region_mask(positions, region)
    return alive
