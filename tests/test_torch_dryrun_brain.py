"""The dry run's brain row: rank r of R through ``dist.LoneComm`` (the
other ranks absent, zeros in their rows) against that rank on a real
``LocalComm`` run, at R=4 with the smoke config, for the paper's four runs
(a) new / dense, (b) old connectivity, (c) sparse exchange, (d) old spikes
(reference lowerings on the CPU). Each rank's collective records (kind,
line size, operand and result bytes, in call order) of a chunk equal the
real rank's, recorded by the same code (``tests/_torch_dryrun.py::RecordingComm``), exactly:
the brain's buffers have static shapes.

The logical bytes by kind are held against ``analyze_hlo`` of JAX's
``lower_sim_step`` at R=4 (one subprocess, 4 host devices). Two ops differ,
each pinned to the byte:
- (b): XLA merges the old connectivity's download of the top tree's
  level-0 counts and centroids (``connectome/routing.py`` ``formation_old``)
  with phase A's identical gathers (``connectome/tree.py`` ``bc`` / ``bz``):
  the port runs both, 8 + 24 bytes a rank, +128 all-gather bytes at R=4;
- (d): the JAX ``exchange_spiked_ids`` gathers the spike counts in an
  all-gather of their own, which XLA drops (nothing reads them); the port
  appends the count to the ids' gather: +4 bytes a rank and step, +1,600
  all-gather bytes over the chunk's 100 steps at R=4.
"""
import dataclasses
import functools

import pytest
import torch

from repro_torch import dist
from repro_torch.configs.msp_brain import SMOKE_CONFIG
from repro_torch.launch import dryrun as dr
from repro_torch.launch import roofline as rl
from repro_torch.sim.api import Simulator

from _torch_dryrun import RecordingComm, finish_jax, start_jax, stop_jax
from _torch_dryrun import one_thread  # noqa: F401 (fixture)

RUNS = {"a": {}, "b": {"connectivity_alg": "old"},
        "c": {"rate_exchange": "sparse"}, "d": {"spike_alg": "old"}}
# port - JAX logical bytes by kind, where XLA rewrote an op (docstring)
PINNED = {"b": {"all-gather": 128}, "d": {"all-gather": 1600}}
R = 4


def _recorded_run(cfg):
    """A real R-rank ``LocalComm`` run: one warm-up chunk, then the records
    of each rank's calls in one chunk."""
    sim = Simulator.from_config(cfg, num_ranks=R, device="cpu")
    for ctx in sim.ctxs:
        ctx.comm = RecordingComm(ctx.comm)
    sim.run(1)
    for ctx in sim.ctxs:
        ctx.comm.records.clear()
    sim.run(1)
    return [ctx.comm.records for ctx in sim.ctxs]


def _fields(recs):
    return [(c.kind, c.n, c.operand_bytes, c.result_bytes) for c in recs]


@functools.lru_cache(maxsize=None)
def _lone(run: str):
    """Rank 0 of R through ``LoneComm`` (``dryrun.brain_chunks``): the
    warm-up chunk's records, the counted chunk's, and its counter."""
    cfg = dataclasses.replace(SMOKE_CONFIG, **RUNS[run])
    _, counter, warm, recs, _ = dr.brain_chunks(cfg, R, "cpu")
    return warm, recs, counter


@pytest.mark.parametrize("run", sorted(RUNS))
def test_lone_comm_counts_equal_a_real_rank(run):
    cfg = dataclasses.replace(SMOKE_CONFIG, **RUNS[run])
    real = _recorded_run(cfg)
    warm, recs, _ = _lone(run)
    assert recs and warm == recs
    assert _fields(recs) == _fields(real[0]), run
    comm = dist.LoneComm(R, R - 1)
    sim = Simulator.from_config(cfg, comm=comm, device="cpu")
    sim.run(1)
    comm.records.clear()
    sim.run(1)
    assert _fields(comm.records) == _fields(real[R - 1]), run


JAX_CODE = """
import dataclasses, json
import numpy as np
from repro.configs.msp_brain import SMOKE_CONFIG
from repro.core import engine
from repro.launch import roofline as rl
from repro.launch.mesh import make_mesh
mesh = make_mesh((4,), ("ranks",))
out = {}
for label, change in %r.items():
    cfg = dataclasses.replace(SMOKE_CONFIG, **change)
    hlo = engine.lower_sim_step(cfg, mesh).compile().as_text()
    out[label] = rl.analyze_hlo(hlo, 4)["collective_logical_bytes"]
np.savez(OUT, json=np.array(json.dumps(out)))
"""


@pytest.fixture(scope="module", autouse=True)
def jax_proc(tmp_path_factory):
    """JAX's four compiles in a subprocess of 4 host devices, started
    before this file's first test so that they overlap the port's runs."""
    path = str(tmp_path_factory.mktemp("brain") / "jax.npz")
    proc = start_jax(JAX_CODE % (RUNS,), path, R)
    yield proc, path
    stop_jax(proc)


@pytest.fixture(scope="module")
def jax_bytes(jax_proc):
    return finish_jax(*jax_proc)


@pytest.mark.parametrize("run", sorted(RUNS))
def test_logical_bytes_against_jax_hlo(jax_bytes, run):
    _, recs, counter = _lone(run)
    got = rl.analyze(recs, counter)["collective_logical_bytes"]
    want = {k: int(v) for k, v in jax_bytes[run].items()}
    diff = {k: got.get(k, 0) - want.get(k, 0) for k in set(got) | set(want)}
    assert {k: v for k, v in diff.items() if v} == PINNED.get(run, {})


@pytest.mark.parametrize("ranks,n,cap", [(65, 10, 40), (256, 64, 7),
                                         (512, 16, 3)])
def test_route_groups_equal_the_plain_route(ranks, n, cap):
    """K5 holds 64 destination buckets: above that its wrapper runs one
    launch a group of 64 ranks (``synapse_apply.route_groups``). The
    grouping itself, each group built by the plain version here, equals
    the plain version over every rank, exactly (buffers and drops)."""
    from repro_torch.kernels import synapse_apply as sa
    g = torch.Generator().manual_seed(ranks)
    other = torch.randint(-ranks * n // 2, ranks * n, (4000,), generator=g,
                          dtype=torch.int32)
    mine = torch.randint(0, n, (4000,), generator=g, dtype=torch.int32)
    kw = dict(n=n, num_ranks=ranks, cap=cap)
    want = sa.route_build_plain(other, mine, **kw)
    got = sa.route_groups(other, mine, build=sa.route_build_plain, **kw)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert float(want[1]) > 0
