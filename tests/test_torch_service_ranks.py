"""The port's service at four ranks (``dist.LocalComm``, one thread a rank
in this process): the JAX package's ``test_isolation_4rank``, held inside
the port under the dense and the sparse exchange. Four tenants, slot 1
NaN-poisoned after its first chunk: the poisoned slot quarantines and rolls
back, every tenant ends bitwise its solo R=4 ``Simulator`` run, and the
co-tenants' observation rows are bitwise those of an unpoisoned run.

The port's R=4 chunk is held against JAX already
(``tests/test_torch_multirank.py``, ``test_torch_compare_sparse.py``), so
this file runs no JAX.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import manager
from repro_torch.configs.msp_brain import BrainConfig
from repro_torch.runtime import chaos
from repro_torch.service import (RequestStatus, ServiceConfig, SimRequest,
                                 SimulationService, SlotBatch)
from repro_torch.sim.api import Simulator

SMALL = dict(neurons_per_rank=32, local_levels=3, frontier_cap=32,
             max_synapses=8, rate_period=10, requests_cap_factor=100,
             subs_cap_factor=100)
SEEDS, CHUNKS, RANKS = (3, 11, 5, 7), 3, 4


def _host(tree):
    return {k: np.array(x.cpu().numpy() if isinstance(x, torch.Tensor)
                        else x) for k, x in manager._flatten(tree)}


@pytest.mark.parametrize("exchange", ["dense", "sparse"])
def test_isolation_4rank(exchange):
    cfg = BrainConfig(**SMALL, rate_exchange=exchange)
    batch = SlotBatch(cfg, 4, num_ranks=RANKS, device="cpu")
    assert batch.num_ranks == RANKS

    svc = SimulationService(cfg, ServiceConfig(num_slots=4), batch=batch)
    svc.chaos_hooks.append(chaos.poison_slot_nan(1, after_chunk=1))
    hs = [svc.submit(SimRequest(seed=s, chunks=CHUNKS)) for s in SEEDS]
    svc.run_until_idle()
    st = svc.stats()
    assert st["quarantines"] >= 1 and st["slot_rollbacks"] >= 1, st
    assert hs[1].retries >= 1

    clean = SimulationService(cfg, ServiceConfig(num_slots=4), batch=batch)
    ch = [clean.submit(SimRequest(seed=s, chunks=CHUNKS)) for s in SEEDS]
    clean.run_until_idle()

    for i, h in enumerate(hs):
        assert h.result.status is RequestStatus.DONE, (i, h)
        sim = Simulator(dataclasses.replace(cfg, seed=h.request.seed),
                        num_ranks=RANKS, device="cpu")
        sim.run(CHUNKS)
        got, want = _host(h.result.final_state), _host(sim.state)
        assert list(got) == list(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=(i, k))
        if i != 1:      # co-tenant observables untouched by the fault
            np.testing.assert_array_equal(h.observations,
                                          ch[i].observations)


def test_poison_writes_one_rank_of_one_lane():
    """``poison_slot_nan`` at a global index writes NaN into the rank state
    that holds it, in that lane only."""
    cfg = BrainConfig(**SMALL)
    svc = SimulationService(cfg, ServiceConfig(num_slots=2),
                            num_ranks=RANKS, device="cpu")
    for s in (1, 2):
        svc.submit(SimRequest(seed=s, chunks=2))
    n = cfg.neurons_per_rank
    chaos.poison_slot_nan(1, field="positions", index=2 * 3 * n + 5)(svc)
    for b, lane in enumerate(svc.state):
        for r, rs in enumerate(lane):
            bad = torch.isnan(rs.positions).nonzero().tolist()
            assert bad == ([[1, 2]] if (b, r) == (1, 2) else []), (b, r)
