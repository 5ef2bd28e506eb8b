"""The port's ``launch/roofline.py`` against the JAX package's:
``wire_factor`` equal for every kind and line size 1-16; ``roofline_terms``
given JAX's TPU table as its ``hw`` (all wire bytes on one link of
``ici_bw`` x 4) equal to JAX's on a grid, including
``tests/test_roofline.py``'s cases; the H100 terms worked by hand for a
line inside a node (NVLink) and one across nodes (InfiniBand); and
``StepCounter`` / ``repeated`` counting what they should. All exact but
where a float division is compared with the same division (equal)."""
import itertools

import pytest
import torch

from repro.launch import roofline as jrl
from repro.launch.mesh import HW as JAX_HW

from repro_torch import dist
from repro_torch.launch import roofline as rl

KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
         "collective-permute", "all-gather-start", "all-reduce-start",
         "collective-permute-start", "other")


def test_wire_factor_equal_to_jax():
    for kind, n in itertools.product(KINDS, range(1, 17)):
        assert rl.wire_factor(kind, n) == jrl.wire_factor(kind, n), (kind, n)


JAX_AS_HW = dict(JAX_HW, links={"ici": JAX_HW["ici_bw"] * 4.0})


@pytest.mark.parametrize("flops,mem,coll", [
    (1e15, 1e9, 1e9), (1e12, 1e9, 1e12), (0.0, 0.0, 0.0), (3e13, 2e11, 0.0),
    (1e12, 5e11, 1e10), (7.5e14, 1e6, 3e11), (1.0, 1e15, 2.0)])
def test_roofline_terms_equal_jax_on_its_table(flops, mem, coll):
    want = jrl.roofline_terms(flops, mem, coll)
    assert rl.roofline_terms(flops, mem, {"ici": coll}, hw=JAX_AS_HW) == want
    assert rl.roofline_terms(flops, mem, coll, hw=JAX_AS_HW) == want


def test_h100_terms_by_hand():
    """(2, 8): a ``model`` line is 8 consecutive ranks, one node (NVLink,
    450e9 B/s); a ``data`` line crosses two nodes (InfiniBand, 50e9)."""
    mesh = dist.ShapeMesh((2, 8), ("data", "model"), rank=5)
    comm = mesh.comm(5)
    x = torch.empty((1024, 256), dtype=torch.bfloat16, device="meta")
    comm.psum(x, "model")            # 512 KiB all-reduce over 8
    comm.all_gather(x, "data")       # result 1 MiB over 2
    nb = 1024 * 256 * 2
    ana = rl.analyze(mesh.records)
    assert [r.intra_node for r in mesh.records] == [True, False]
    nv = nb * 2.0 * 7 / 8
    ib = 2 * nb * 1 / 2
    assert ana["collective_wire_bytes_by_link"] == {"nvlink": nv, "ib": ib}
    assert ana["collective_logical_bytes"] == {"all-reduce": nb,
                                               "all-gather": 2 * nb}
    terms = rl.roofline_terms(989e12, 3.35e12 / 2,
                              ana["collective_wire_bytes_by_link"])
    assert terms["t_compute_s"] == 1.0 and terms["t_memory_s"] == 0.5
    assert terms["t_collective_s"] == nv / 450e9 + ib / 50e9
    assert terms["dominant"] == "compute"
    assert terms["roofline_fraction"] == 1.0


def test_step_counter_counts_products_bytes_and_peak():
    c = rl.StepCounter()
    a = torch.randn(8, 16)
    b = torch.randn(16, 4)
    with c:
        y = a @ b                                     # mm: 2*8*16*4
        z = torch.addmm(torch.zeros(8, 4), a, b)      # addmm: the same
        bb = torch.bmm(a[None], b[None])              # bmm: the same
        v = a.view(16, 8)                             # a view: no bytes
        w = torch.nn.functional.conv1d(torch.randn(1, 2, 10),
                                       torch.randn(3, 2, 4))
        del y
        big = torch.empty(1000)
        del big
    f = 2 * 8 * 16 * 4
    conv = 2 * 3 * 7 * 2 * 4
    assert c.dot_flops == 3 * f + conv
    assert c.dot_flops_by_op["mm"] == f and c.dot_flops_by_op["bmm"] == f
    assert v.shape == (16, 8) and w.shape == (1, 3, 7) and z is not None
    assert c.materialized_bytes >= (3 * 32 + 1000) * 4
    assert c.peak_bytes >= 1000 * 4
    assert c.live_bytes < c.peak_bytes
    del bb


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_repeated_counts_forward_and_backward_n_times(device):
    w = torch.randn(8, 8, device=device, requires_grad=True)
    x = torch.randn(4, 8, device=device, requires_grad=True)

    def step(a, p):
        return torch.tanh(a @ p["w"])

    once = rl.StepCounter()
    with once:
        step(x, {"w": w}).sum().backward()
    five = rl.StepCounter()
    with five:
        y = dist.repeated(5, step, x, {"w": w})
        y.sum().backward()
    assert five.dot_flops == 5 * once.dot_flops
    assert x.grad.shape == x.shape and w.grad.shape == w.shape
    with torch.no_grad():
        ng = rl.StepCounter()
        with ng:
            dist.repeated(3, step, x, {"w": w})
    assert ng.dot_flops == 3 * 2 * 4 * 8 * 8
    with ng, dist.repeat(2), dist.repeat(3):
        assert dist.count_times() == 6


def test_report_tables_read_the_ports_records():
    """``launch/report.py`` over two records of the port's keys: a traced
    cell and a skipped one, on both meshes."""
    from repro_torch.launch import report
    terms = rl.roofline_terms(989e12, 3.35e12 / 2, {"ib": 25e9})
    recs = [dict(arch="qwen2-7b", shape="train_4k", mesh=m, ok=True,
                 trace_s=6.1, dot_flops_per_dev=989e12,
                 collective_bytes_per_dev=5e10, param_bytes_per_dev=6e7,
                 useful_flops_ratio=0.18, **terms)
            for m in ("16x16", "2x16x16")]
    recs += [dict(arch="qwen2-7b", shape="long_500k", mesh=m, ok=True,
                  skipped=True, reason="full-attention arch: quadratic")
             for m in ("16x16", "2x16x16")]
    for mesh in ("16x16", "2x16x16"):
        table = report.roofline_table(recs, mesh)
        assert "| qwen2-7b | train_4k | 1.00s | 500.0ms | 500.0ms | " \
               "compute | 1.000 | 0.18 |" in table
        assert "| qwen2-7b | long_500k | - | - | - | - | - | - | N/A: " \
               "full-attention arch: quadratic |" in table
        assert len(table.splitlines()) == 4
    assert "| 6.1 | 989.00T | 46.6GB | 57.2MB | ok |" in \
        report.dryrun_table(recs)
