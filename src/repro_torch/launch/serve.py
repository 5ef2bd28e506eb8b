"""Serving driver for the multi-tenant brain simulation service
(``repro_torch.service``), the port of the JAX package's
``repro/launch/serve.py``: spin up a ``SimulationService``, submit a
workload of tenant requests (one seed each), drive it to idle, and print
per-tenant outcomes + service lifecycle counters.

  PYTHONPATH=src python -m repro_torch.launch.serve --smoke
  PYTHONPATH=src python -m repro_torch.launch.serve \\
      --slots 4 --tenants 8 --chunks 5 --neurons 128
  PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu

Runs on the card unless ``--device`` names another (``device.
resolve_device``: without a card and without ``--device cpu`` it raises).
Every lane runs the five fused lowerings (activity, connectivity, tree,
apply): on the card they launch the hand-written kernels, and on the CPU
their wrappers run the plain versions, so the tenant lines are those of
the JAX driver, whose service serves the reference lowerings only.
``--poison-slot N`` runs the chaos demo: one tenant's lane is NaN-poisoned
mid-run and must be quarantined, rolled back, and finished via retry while
the co-tenants complete untouched.
"""
from __future__ import annotations

import argparse

from repro_torch import telemetry
from repro_torch.configs.msp_brain import BrainConfig
from repro_torch.runtime import chaos
from repro_torch.service import ServiceConfig, SimRequest, SimulationService


def build_config(args) -> BrainConfig:
    """The JAX driver's config, with every lowering fused."""
    return BrainConfig(
        neurons_per_rank=args.neurons,
        local_levels=args.levels,
        frontier_cap=args.neurons,
        max_synapses=8,
        rate_period=10,
        requests_cap_factor=100,
        subs_cap_factor=100,
        rate_exchange=args.exchange,
        activity_impl="fused", connectivity_impl="fused",
        tree_impl="fused", apply_impl="fused")


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="multi-tenant brain simulation service driver")
    ap.add_argument("--smoke", action="store_true",
                    help="tiny fixed workload (2 slots, 3 tenants)")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--tenants", type=int, default=8)
    ap.add_argument("--chunks", type=int, default=5,
                    help="chunk budget per tenant")
    ap.add_argument("--neurons", type=int, default=128,
                    help="neurons per rank")
    ap.add_argument("--levels", type=int, default=4,
                    help="local octree levels")
    ap.add_argument("--exchange", default="dense",
                    choices=("dense", "sparse"))
    ap.add_argument("--queue-cap", type=int, default=16)
    ap.add_argument("--deadline-s", type=float, default=None,
                    help="per-request wall-clock deadline")
    ap.add_argument("--poison-slot", type=int, default=None,
                    help="chaos demo: NaN-poison this slot mid-run")
    ap.add_argument("--heartbeat", default=None,
                    help="heartbeat JSON path")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    if args.smoke:
        args.slots, args.tenants, args.chunks = 2, 3, 3
        args.neurons, args.levels = 32, 3

    cfg = build_config(args)
    svc = SimulationService(
        cfg, ServiceConfig(num_slots=args.slots,
                           queue_cap=args.queue_cap,
                           heartbeat_path=args.heartbeat),
        device=args.device)
    if args.poison_slot is not None:
        svc.chaos_hooks.append(
            chaos.poison_slot_nan(args.poison_slot, after_chunk=1))

    handles = [svc.submit(SimRequest(seed=100 + i, chunks=args.chunks,
                                     priority=i % 2,
                                     deadline_s=args.deadline_s,
                                     tag=f"tenant{i}"))
               for i in range(args.tenants)]
    with telemetry.span("serve.drive", tenants=args.tenants):
        svc.run_until_idle()

    for h in handles:
        r = h.result
        print(f"  {h.request.tag:>10}  seed={h.request.seed}  "
              f"{r.status.value:<18} chunks={r.chunks_done}/"
              f"{h.request.chunks}  retries={r.retries}")
    stats = svc.stats()
    print("service:", {k: v for k, v in sorted(stats.items()) if v})
    done = sum(1 for h in handles
               if h.result is not None and h.result.status.name == "DONE")
    print(f"{done}/{len(handles)} tenants DONE")
    return 0 if done == len(handles) or args.poison_slot is not None \
        else 1


if __name__ == "__main__":
    raise SystemExit(main())
