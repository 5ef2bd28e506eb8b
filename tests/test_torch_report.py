"""The port's ``telemetry/report.py`` (the ``repro.telemetry/v1`` schema)
against the JAX package's: every block from the same numpy arrays (each
package's ``Metrics`` built from them), ``normalize`` on a v1 report and on
both pre-schema layouts (written inline here), the JSON round trip, and
``roofline_block`` from a dry-run record and from an ``analyze`` result.
All exact (the blocks are floats and ints copied from the inputs)."""
import dataclasses
import enum

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.telemetry import metrics as jtm
from repro.telemetry import report as jrep

from repro_torch import dist
from repro_torch import telemetry as ttel
from repro_torch.launch import roofline as rl
from repro_torch.telemetry import metrics as ttm
from repro_torch.telemetry import report as trep


def _metrics(seed: int, ranks: int = 3):
    """The same counters, histograms and gauges (ranks leading) as a JAX
    and a port ``Metrics``."""
    rng = np.random.default_rng(seed)
    counters = {k: rng.integers(0, 1000, ranks).astype(np.float32)
                for k in ttm.COUNTER_KEYS}
    hists = {k: rng.integers(0, 50, (ranks, b)).astype(np.float32)
             for k, b in ttm.HIST_BUCKETS.items()}
    gauges = {k: rng.integers(0, 8, ranks).astype(np.float32)
              for k in ttm.GAUGE_KEYS}
    per_chunk = {k: np.zeros((ranks, 4), np.float32)
                 for k in ttm.COUNTER_KEYS}

    def build(cls, conv):
        return cls(counters={k: conv(v) for k, v in counters.items()},
                   per_chunk={k: conv(v) for k, v in per_chunk.items()},
                   hists={k: conv(v) for k, v in hists.items()},
                   gauges={k: conv(v) for k, v in gauges.items()})
    return build(jtm.Metrics, jnp.asarray), build(ttm.Metrics,
                                                  torch.from_numpy)


class _Status(enum.Enum):
    DONE = "done"
    FAILED = "failed"


@dataclasses.dataclass
class _Handle:
    status: _Status


@pytest.mark.parametrize("seed", [0, 1])
def test_blocks_equal_jax(seed):
    jm, tm = _metrics(seed)
    assert trep.counters_block(tm) == jrep.counters_block(jm)
    assert trep.histograms_block(tm) == jrep.histograms_block(jm)
    life = {k: i for i, k in enumerate(ttm.LIFECYCLE_KEYS)}
    assert trep.lifecycle_block(life) == jrep.lifecycle_block(life)
    stats = {"admitted": 6, "completed": 5, "rollbacks": 1}
    handles = [_Handle(_Status.DONE)] * 5 + [_Handle(_Status.FAILED)]
    assert trep.service_block(stats, handles) == \
        jrep.service_block(stats, handles)
    assert trep.service_block(stats) == jrep.service_block(stats)
    q = {"recall_overlap": 0.75, "selectivity": 3, "flag": True, "x": "s"}
    assert trep.quality_block(q) == jrep.quality_block(q)
    assert trep.timing(12.5, 340.0, "step") == jrep.timing(12.5, 340.0,
                                                           "step")


def _report(pkg, tm, spans):
    return pkg.make_report(
        "activity", {"n32": pkg.case({"n_per_rank": 32, "num_ranks": 3},
                                     {"fused_compile_ms": 10.0,
                                      "hbm_bytes_ratio": np.float32(25.0),
                                      "ok": True, "note": "x"})},
        smoke=True, mesh={"num_ranks": 3, "backend": "cuda"},
        counters=pkg.counters_block(tm), histograms=pkg.histograms_block(tm),
        spans=spans, roofline={"dot_flops": 1.0},
        lifecycle={"checkpoint_saves": 2}, service={"lifecycle": {}},
        quality={"recall_overlap": 0.5})


def test_make_report_and_case_equal_jax(tmp_path):
    jm, tm = _metrics(2)
    spans = [{"name": "sim.run", "ms": 1.5}]
    port, ref = _report(trep, tm, spans), _report(jrep, jm, spans)
    assert port == ref
    path = str(tmp_path / "r.json")
    trep.write(path, port)
    back = trep.load(path)
    assert back == port
    assert trep.normalize(back) == jrep.normalize(back)
    assert ttel.report is trep


# the pre-schema layouts, as the old BENCH_*.json files hold them
OLD_ACTIVITY = {"n_per_rank": 4096, "num_ranks": 1, "smoke": False,
                "fused_compile_ms": 812.5, "steady_us_per_step": 41.25,
                "hbm_bytes_ratio": 25.0, "bitwise": True}
OLD_CONNECTIVITY = {"smoke": True,
                    "n256": {"n_per_rank": 256, "num_ranks": 4, "s_max": 8,
                             "old_ms": 12.5, "new_ms": 3.25, "ratio": 3.85},
                    "n512": {"n_per_rank": 512, "num_ranks": 4,
                             "old_ms": 30.0, "new_ms": 6.5, "delta": 100}}


@pytest.mark.parametrize("obj", [OLD_ACTIVITY, OLD_CONNECTIVITY],
                         ids=["flat_single_case", "cases_by_name"])
def test_normalize_pre_schema_equal_jax(obj):
    for bench in (None, "connectivity"):
        assert trep.normalize(obj, bench) == jrep.normalize(obj, bench)


def test_normalize_v1_equal_jax():
    jm, tm = _metrics(3)
    rep = _report(trep, tm, None)
    assert trep.normalize(rep) == jrep.normalize(rep)
    assert trep.normalize(rep)["cases"]["n32"]["metrics"][
        "hbm_bytes_ratio"] == 25.0


def test_mesh_block_names_the_backend():
    assert trep.mesh_block(4, "cpu") == {"num_ranks": 4, "backend": "cpu"}
    assert trep.mesh_block(1, torch.device("cuda", 0))["backend"] == "cuda"


def test_roofline_block_from_analyze_and_record():
    """The third source: from an ``analyze`` result (terms on the
    materialized bytes, the wire bytes by link) and from a dry-run record
    (its own terms), the JAX block's keys."""
    mesh = dist.ShapeMesh((2, 8), ("data", "model"))
    comm = mesh.comm(0)
    counter = rl.StepCounter()
    with counter:
        x = torch.empty((64, 32), device="meta")
        y = comm.psum(x @ torch.empty((32, 16), device="meta"), "model")
        comm.all_gather(y, "data")
    ana = rl.analyze(mesh.records, counter)
    blk = trep.roofline_block(ana)
    assert set(blk) == {"collective_wire_bytes", "collective_bytes_total",
                        "dot_flops", "materialized_hbm_bytes", "terms"}
    assert blk["dot_flops"] == 2 * 64 * 32 * 16
    assert blk["terms"] == rl.roofline_terms(
        ana["dot_flops"], ana["materialized_bytes"],
        ana["collective_wire_bytes_by_link"])
    rec = {"collectives": {"all-gather": 8.0}, "collective_bytes_per_dev": 8.0,
           "dot_flops_per_dev": 3.0, "materialized_bytes": 5,
           **rl.roofline_terms(3.0, 5, 8.0)}
    blk = trep.roofline_block(rec)
    assert blk["terms"]["t_compute_s"] == 3.0 / rl.HW["peak_flops_bf16"]
    assert blk["collective_bytes_total"] == 8.0
