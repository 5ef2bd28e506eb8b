"""Engram formation and pattern completion, the port's copy of the JAX
package's ``repro/workloads/engram.py``.

Follows the structural-plasticity learning protocol of Tiddia et al.
(arXiv:2307.11735) on the MSP engine: a *pattern* region is stimulated
while the connectome grows, so the homeostatic rule wires the co-active
ensemble together (the engram); after a rest period the *cue* subregion of
the pattern is lesioned (its synapses retract, partners are notified), and
recall is probed with a weaker stimulus on the pattern. The quality
observable is **recall overlap**: the fraction of surviving pattern neurons
(pattern minus cue) whose window-averaged rate clears a threshold during the
probe, next to the *selectivity* margin over the unstimulated rest of the
sheet.

Everything is a plain protocol (``Stimulate`` / ``Lesion`` events), so the
workload runs bitwise the same across the dense and sparse rate exchanges
and the reference and fused activity lowerings.

    python -m repro_torch.workloads.engram --smoke --device cpu
    python -m repro_torch.workloads.engram --connectome       # on the card
"""
from __future__ import annotations

import dataclasses
import json
from typing import Optional

import torch

from repro_torch.configs.msp_brain import SMOKE_CONFIG, BrainConfig
from repro_torch.scenarios.protocol import Lesion, Scenario, Stimulate
from repro_torch.scenarios.regions import Region, region_mask
from repro_torch.sim.api import Simulator


@dataclasses.dataclass(frozen=True)
class EngramSpec:
    """The engram protocol. ``cue`` must be a subregion of ``pattern`` (the
    lesioned fraction of the ensemble); times are in chunks of
    ``cfg.rate_period`` steps."""
    pattern: Region = Region("pattern", lo=(0.0, 0.0, 0.0),
                             hi=(0.5, 1.0, 1.0))
    cue: Region = Region("cue", lo=(0.0, 0.0, 0.0), hi=(0.25, 1.0, 1.0))
    train_chunks: int = 6
    rest_chunks: int = 2
    recall_chunks: int = 4
    train_amplitude: float = 4.0    # training drive (cf. focal_stimulation)
    recall_amplitude: float = 2.0   # weaker recall probe
    rate_threshold: float = 0.02    # "active" rate (per step; bg ~0.01)

    @property
    def total_chunks(self) -> int:
        return self.train_chunks + self.rest_chunks + self.recall_chunks


def scenario(spec: EngramSpec, rate_period: int) -> Scenario:
    """Compile the spec into a protocol Scenario. The cue region rides along
    for the lesion mask; the recall probe stimulates the whole pattern, but
    lesioned cue neurons are dead and cannot respond: only the surviving
    ensemble (pattern minus cue) can complete it."""
    t_train = spec.train_chunks * rate_period
    t_recall = (spec.train_chunks + spec.rest_chunks) * rate_period
    t_end = spec.total_chunks * rate_period
    return Scenario(
        name="engram",
        regions=(spec.pattern, spec.cue),
        events=(
            Stimulate(spec.pattern.name, spec.train_amplitude, 0, t_train),
            Lesion(spec.cue.name, t_recall),
            Stimulate(spec.pattern.name, spec.recall_amplitude, t_recall,
                      t_end),
        ),
        num_chunks=spec.total_chunks)


def recall_metrics(state, spec: EngramSpec) -> dict:
    """The quality readout on the final global state (one transfer of four
    scalars). ``recall_overlap``: the fraction of target neurons (pattern
    minus the lesioned cue) active at the end of the recall probe;
    ``background_activation`` the same fraction outside the pattern;
    ``engram_selectivity`` their margin."""
    pat = region_mask(state.positions, spec.pattern)
    cue = region_mask(state.positions, spec.cue)
    target = pat & ~cue
    outside = ~pat
    active = state.neurons.rate >= spec.rate_threshold
    n_t = torch.clamp_min(target.sum(), 1)
    n_o = torch.clamp_min(outside.sum(), 1)
    overlap = (active & target).sum().to(torch.float32) / n_t
    background = (active & outside).sum().to(torch.float32) / n_o
    vals = torch.stack([overlap, background,
                        target.sum().to(torch.float32),
                        cue.sum().to(torch.float32)]).cpu().tolist()
    return {"recall_overlap": vals[0],
            "background_activation": vals[1],
            "engram_selectivity": vals[0] - vals[1],
            "target_neurons": vals[2],
            "cue_neurons": vals[3]}


def run_engram(cfg: Optional[BrainConfig] = None,
               spec: EngramSpec = EngramSpec(), dataset=None,
               num_ranks: int = 1, device=None, comm=None):
    """Run the full protocol and return ``(metrics, sim)``.

    With ``dataset`` the sheet starts from the loaded connectome
    (``Simulator.from_connectome``) instead of growing from empty: the
    engram then forms by rewiring a heavy-tailed connectome rather than by
    growth alone. Runs on the card unless ``device`` names another."""
    cfg = cfg or dataclasses.replace(SMOKE_CONFIG, requests_cap_factor=1000)
    scn = scenario(spec, cfg.rate_period)
    if dataset is not None:
        sim = Simulator.from_connectome(cfg, dataset, scenario=scn,
                                        num_ranks=num_ranks, device=device,
                                        comm=comm)
    else:
        sim = Simulator.from_config(cfg, scenario=scn, num_ranks=num_ranks,
                                    device=device, comm=comm)
    sim.run(spec.total_chunks)
    return recall_metrics(sim.state, spec), sim


def main(argv=None) -> dict:
    import argparse
    p = argparse.ArgumentParser(description="engram workload")
    p.add_argument("--smoke", action="store_true",
                   help="smoke scale (64 neurons/rank)")
    p.add_argument("--sparse", action="store_true",
                   help="sparse rate exchange")
    p.add_argument("--connectome", action="store_true",
                   help="start from a generated surrogate connectome")
    p.add_argument("--device", default=None,
                   help="torch device (default: the card)")
    args = p.parse_args(argv)
    cfg = dataclasses.replace(
        SMOKE_CONFIG, requests_cap_factor=1000,
        rate_exchange="sparse" if args.sparse else "dense")
    if not args.smoke:
        cfg = dataclasses.replace(cfg, neurons_per_rank=256)
    dataset = None
    if args.connectome:
        from repro_torch.workloads import datasets as wds
        dataset = wds.generate_hemibrain_surrogate(
            cfg.neurons_per_rank, cfg.neurons_per_rank,
            max_degree=cfg.max_synapses,
            fraction_excitatory=cfg.fraction_excitatory)
    metrics, sim = run_engram(cfg, dataset=dataset, device=args.device)
    metrics["chunks"] = float(EngramSpec().total_chunks)
    metrics["synapses_formed"] = sim.stats()["synapses_formed"]
    print(json.dumps(metrics, indent=2, sort_keys=True))
    return metrics


if __name__ == "__main__":
    main()
