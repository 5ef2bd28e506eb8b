"""The port's CUDA kernels against their plain versions on the card, at
small sizes. Marked ``cuda``: they skip on a machine without an NVIDIA GPU
(the CPU tests hold the plain versions against the JAX package) and run on
the card with ``python -m pytest -m cuda tests/test_torch_cuda.py``."""
import dataclasses

import pytest
import torch

from repro_torch.configs.msp_brain import SMOKE_CONFIG
from repro_torch.connectome import traverse
from repro_torch.connectome import tree as ctree
from repro_torch.connectome.synapses import compact
from repro_torch.core import engine
from repro_torch.kernels import activity_fused as af
from repro_torch.kernels import bh_traverse as bt
from repro_torch.kernels import hash as chash
from repro_torch.kernels import radix_sort as rs
from repro_torch.kernels import synapse_apply as sa
from repro_torch.scenarios import library, observables
from repro_torch.scenarios.protocol import Lesion, Stimulate
from repro_torch.sim.api import Simulator

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def test_threefry_words_bit_equal(dev):
    g = torch.Generator(device=dev).manual_seed(0)
    w = [torch.randint(0, 2 ** 32, (4099,), generator=g, device=dev,
                       dtype=torch.int64) for _ in range(4)]
    for a, b in zip(chash.threefry_words(*w), chash.threefry2x32(*w)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("num_ranks,rank", [(1, 0), (4, 1)])
def test_activity_window_equals_plain(dev, num_ranks, rank):
    n, s, steps = 1000, 8, 13
    g = torch.Generator(device=dev).manual_seed(1)
    state = (torch.randn(n, generator=g, device=dev) * 5 - 60,
             torch.randn(n, generator=g, device=dev) * 2 - 13,
             torch.rand(n, generator=g, device=dev),
             torch.rand(n, generator=g, device=dev) * 2,
             torch.rand(n, generator=g, device=dev) * 2,
             torch.rand(n, generator=g, device=dev) < 0.2,
             torch.zeros(n, device=dev))
    edges = torch.randint(-1, num_ranks * n, (n, s), generator=g,
                          device=dev, dtype=torch.int32)
    w = torch.where(torch.arange(n, device=dev) < 800, 15.0, -15.0)
    rates = torch.rand(num_ranks, n, generator=g, device=dev) * 0.2
    izh = (0.02, 0.2, -65.0, 8.0, 1e-3, 0.7)
    kw = dict(seed=3, num_steps=steps, izh=izh, ca_consts=(1e-4, 2.4e-3))
    before = af.launches.count
    a, a_spk = af.activity_window(state, edges, w, rates, 5.0, 1.0, 2, rank,
                                  **kw)
    b, b_spk = af.window_plain(state, edges, w, rates, 5.0, 1.0, 2, rank,
                               **kw)
    assert af.launches.count == before + steps
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert torch.equal(a_spk, b_spk)


def test_bh_traverse_equals_plain(dev):
    cfg = SMOKE_CONFIG
    st = engine.init_state(dataclasses.replace(cfg, neurons_per_rank=512),
                           0, 1, device=dev)
    tree = ctree.build_local_tree(st.positions, st.neurons.de_elements, 0,
                                  cfg, 1)
    stacked = traverse.stack_levels(tree.counts, tree.centroids, 0)
    q = st.positions.shape[0]
    gids = torch.arange(q, dtype=torch.int32, device=dev)
    args = (stacked.counts, stacked.centroids, tree.leaf_members,
            st.positions, st.neurons.de_elements, st.positions,
            torch.zeros_like(gids), gids, gids % 7 != 0, 4, 0)
    kw = dict(seed=cfg.seed, sizes=stacked.sizes, theta=cfg.theta,
              sigma=cfg.sigma, frontier=cfg.frontier_cap,
              n_levels=cfg.local_levels + 1)
    for a, b in zip(bt.bh_traverse(*args, **kw),
                    traverse.phase_b_core(*args, **kw)):
        assert torch.equal(a, b)


def test_fused_simulator_equals_reference_on_the_card(dev):
    out = {}
    for impl in ("reference", "fused"):
        cfg = dataclasses.replace(SMOKE_CONFIG, activity_impl=impl,
                                  connectivity_impl=impl)
        sim = Simulator.from_config(cfg, device=dev)
        sim.run(3)
        out[impl] = sim.state
    assert torch.equal(out["reference"].in_edges, out["fused"].in_edges)
    assert torch.equal(out["reference"].neurons.v, out["fused"].neurons.v)


def _window_case(dev, n=1000, s=8, steps=13, num_ranks=1):
    g = torch.Generator(device=dev).manual_seed(1)
    state = (torch.randn(n, generator=g, device=dev) * 5 - 60,
             torch.randn(n, generator=g, device=dev) * 2 - 13,
             torch.rand(n, generator=g, device=dev),
             torch.rand(n, generator=g, device=dev) * 2,
             torch.rand(n, generator=g, device=dev) * 2,
             torch.rand(n, generator=g, device=dev) < 0.2,
             torch.zeros(n, device=dev))
    edges = torch.randint(-1, num_ranks * n, (n, s), generator=g,
                          device=dev, dtype=torch.int32)
    w = torch.where(torch.arange(n, device=dev) < 800, 15.0, -15.0)
    rates = torch.rand(num_ranks, n, generator=g, device=dev) * 0.2
    masks = torch.rand(3, n, generator=g, device=dev) < 0.4
    return state, edges, w, rates, masks


def test_activity_window_with_stimulus_and_lesions_equals_plain(dev):
    """Event windows that open and close inside the window (gsteps 26..38)."""
    steps = 13
    state, edges, w, rates, masks = _window_case(dev, steps=steps)
    stim = (masks[:2].to(torch.float32),
            ((4.0, 29, 33), (-2.5, 20, 1 << 30)))
    lesions = (masks[1:], ((31, 1 << 30), (0, 28)))
    kw = dict(seed=3, num_steps=steps, izh=(0.02, 0.2, -65.0, 8.0, 1e-3, 0.7),
              ca_consts=(1e-4, 2.4e-3), stim=stim, lesions=lesions)
    a, a_spk = af.activity_window(state, edges, w, rates, 5.0, 1.0, 2, 0,
                                  **kw)
    b, b_spk = af.window_plain(state, edges, w, rates, 5.0, 1.0, 2, 0, **kw)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert torch.equal(a_spk, b_spk)
    dead = masks[1]                  # dead from gstep 31 to the end
    assert not bool(a[5][dead].any())
    assert not bool(a[3][dead].any()) and not bool(a[4][dead].any())


@pytest.mark.parametrize("clustered", [False, True])
def test_morton_sort_equals_plain(dev, clustered):
    g = torch.Generator(device=dev).manual_seed(2)
    n = 5000
    pos = torch.rand(n, 3, generator=g, device=dev)
    if clustered:
        pos = torch.clamp(pos * 1e-3 + 0.3, 0.0, 1.0 - 1e-6)
    before = rs.launches.count
    got = rs.morton_sort(pos, 512, leaf_level=4, n_leaf=2048)
    want = rs.morton_sort_plain(pos, 512, leaf_level=4, n_leaf=2048)
    assert rs.launches.count == before + 1
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("crowd", [False, True])
def test_synapse_apply_equals_plain(dev, crowd):
    g = torch.Generator(device=dev).manual_seed(3)
    n, s, qm, qr = 3000, 32, 4000, 6000
    edges = torch.randint(-1, 2 * n, (n, s), generator=g, device=dev,
                          dtype=torch.int32)
    edges = compact(torch.where(torch.rand(n, s, generator=g,
                                                device=dev) < 0.5, -1, edges))
    live = torch.nonzero(edges >= 0)
    pick = live[torch.randint(0, live.shape[0], (qm,), generator=g,
                              device=dev)]
    mlid = pick[:, 0].to(torch.int32)
    mgid = edges[pick[:, 0], pick[:, 1]]
    mgid[::5] = 7
    mval = torch.rand(qm, generator=g, device=dev) < 0.9
    hi = 4 if crowd else n
    rlid = torch.randint(0, hi, (qr,), generator=g, device=dev,
                         dtype=torch.int32)
    rsrc = torch.randint(0, 2 * n, (qr,), generator=g, device=dev,
                         dtype=torch.int32)
    rval = torch.rand(qr, generator=g, device=dev) < 0.9
    prio = torch.randint(0, 50, (qr,), generator=g, device=dev) / 50.0
    vac = torch.rand(n, generator=g, device=dev) * 40
    args = (edges, mlid, mgid, mval, rlid, rsrc, rval, prio, vac)
    before = sa.apply_launches.count
    got = sa.synapse_apply(*args)
    want = sa.synapse_apply_plain(*args)
    assert sa.apply_launches.count == before + 1
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("num_ranks,cap", [(1, 4096), (1, 1 << 20), (3, 900)])
def test_route_build_equals_plain(dev, num_ranks, cap):
    g = torch.Generator(device=dev).manual_seed(4)
    n, s = 3000, 32
    other = torch.randint(-1, num_ranks * n, (n * s,), generator=g,
                          device=dev, dtype=torch.int32)
    other = torch.where(torch.rand(n * s, generator=g, device=dev) < 0.5,
                        -1, other)
    mine = torch.arange(n * s, device=dev, dtype=torch.int32) // s
    before = sa.route_launches.count
    got = sa.route_build(other, mine, n=n, num_ranks=num_ranks, cap=cap)
    want = sa.route_build_plain(other, mine, n=n, num_ranks=num_ranks,
                                cap=cap)
    assert sa.route_launches.count == before + 1
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("name", sorted(library.SCENARIOS))
def test_all_fused_lowerings_equal_reference_under_scenarios(dev, name):
    scn = library.get_scenario(name)
    scn = dataclasses.replace(scn, events=tuple(
        dataclasses.replace(e, t=e.t // 5) if isinstance(e, Lesion) else
        dataclasses.replace(e, t0=e.t0 // 5, t1=e.t1 // 5)
        for e in scn.events))
    out = {}
    for impl in ("reference", "fused"):
        cfg = dataclasses.replace(
            library.SMOKE_SCENARIO_CONFIG, activity_impl=impl,
            connectivity_impl=impl, tree_impl=impl, apply_impl=impl)
        sim = Simulator.from_config(cfg, scenario=scn, device=dev)
        rec = observables.init_recorder(4, len(scn.regions) + 1, device=dev)
        st, rec = sim.run(4, recorder=rec)
        out[impl] = (st, observables.flush(rec))
    a, b = out["reference"], out["fused"]
    assert torch.equal(a[0].in_edges, b[0].in_edges)
    assert torch.equal(a[0].out_edges, b[0].out_edges)
    assert torch.equal(a[0].neurons.v, b[0].neurons.v)
    for k in observables.FIELDS:
        assert (a[1][k] == b[1][k]).all(), k
