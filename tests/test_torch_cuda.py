"""The port's CUDA kernels against their plain versions on the card, at
small sizes. Marked ``cuda``: they skip on a machine without an NVIDIA GPU
(the CPU tests hold the plain versions against the JAX package) and run on
the card with ``python -m pytest -m cuda tests/test_torch_cuda.py``.

Tolerances: the integer kernels (K0, K3-K6) and the elementwise float
kernels built with --fmad=false in the plain versions' order (K1, K2, K7's
P, K8) are bit-equal. K1 sums a row in another order than ``torch.sum``:
bit-equal with integer weights (the model's), and with non-integer weights
within 1e-5 relative, step-synced, spike flags differing only at near-ties
(|v - 30| < 1e-3), as ``chip_smoke.py`` holds it. K7's row sums are taken in another fixed order: 1e-6
relative. K9 sums in another order with an online softmax: 2e-5 in f32,
the JAX kernel tests' tolerance. In bf16 it also rounds p before P V, and
each element is held within ``flash_attention.bf16_error_bound`` of the
plain version (one bf16 ulp of the output plus the spread of the p
roundings): a fixed 2e-2 would be as large as the output at long rows."""
import dataclasses

import pytest
import torch

from repro_torch.configs.msp_brain import SMOKE_CONFIG
from repro_torch.connectome import traverse
from repro_torch.connectome import tree as ctree
from repro_torch.connectome.synapses import compact
from repro_torch.core import engine
from repro_torch.core.neuron import NeuronParams
from repro_torch.kernels import activity_fused as af
from repro_torch.kernels import bh_gauss as bg
from repro_torch.kernels import bh_traverse as bt
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import hash as chash
from repro_torch.kernels import neuron_step as ns
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
    assert af.launches.count == before + 1       # one launch a window
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


def test_facade_docstring_example_runs_on_the_card(dev):
    """``sim/api.py``'s own example, no device named anywhere: the
    simulator, its state and the recorder all land on the card."""
    scn = dataclasses.replace(library.lesion_rewiring(),
                              events=(Lesion("core", t=100),))
    nb = len(scn.regions) + 1
    cfg = library.SMOKE_SCENARIO_CONFIG
    sim = Simulator.from_config(cfg, scenario=scn)
    sim.run(1)
    state, rec = sim.run(1, recorder=observables.init_recorder(1, nb))
    assert sim.stats()["synapses_formed"] >= 0
    assert state.positions.device.type == "cuda"
    assert rec.calcium.device.type == "cuda" and rec.idx == 1
    assert engine.init_state(cfg, 0, 1).positions.device.type == "cuda"


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


_IZH = (0.02, 0.2, -65.0, 8.0, 1e-3, 0.7)


def _k1_both(dev, n, s, steps, num_ranks=1, rank=0, chunk=2, w=None,
             empty_share=0.0, **tables):
    """K1 and its plain version on one random window, with a share of the
    slots emptied anywhere in the rows. Returns (kernel out, plain out, the
    kernel's device launches by mode)."""
    state, edges, w0, rates, _ = _window_case(dev, n=n, s=s, steps=steps,
                                              num_ranks=num_ranks)
    if empty_share:
        g = torch.Generator(device=dev).manual_seed(22)
        edges = torch.where(torch.rand(n, s, generator=g, device=dev)
                            < empty_share, -1, edges)
    kw = dict(seed=3, num_steps=steps, izh=_IZH, ca_consts=(1e-4, 2.4e-3),
              **tables)
    args = (state, edges, w0 if w is None else w, rates, 5.0, 1.0, chunk,
            rank)
    af.device_launches(reset=True)
    got = af.activity_window(*args, **kw)
    torch.cuda.synchronize()
    ran = af.device_launches(reset=True)
    return got, af.window_plain(*args, **kw), ran


def _assert_window_equal(got, want):
    for x, y in zip(got[0], want[0]):
        assert torch.equal(x, y)
    assert torch.equal(got[1], want[1])


@pytest.mark.parametrize("n,s", [(1000, 1), (1000, 8), (4099, 17),
                                 (4099, 32), (100_003, 8)])
def test_activity_window_shapes_equal_plain(dev, n, s):
    """n not a multiple of a block's range (nor of 32), S of 1, 8, 17 and
    32, a block holding two tiles of 512 neurons (n = 100,003 at S = 8), R =
    4 rank 1, all in the staged mode."""
    got, want, ran = _k1_both(dev, n, s, 13, num_ranks=4, rank=1)
    _assert_window_equal(got, want)
    assert ran == {"staged": 1, "streaming": 0}


@pytest.mark.parametrize("empty_share", [0.7, 1.0])
def test_activity_window_sparse_rows_equal_plain(dev, empty_share):
    """Rows with empty slots anywhere (not compacted), most of them empty,
    or all: the slot loop stops after a row's last used slot."""
    got, want, _ = _k1_both(dev, 3000, 32, 13, num_ranks=4, rank=1,
                            empty_share=empty_share)
    _assert_window_equal(got, want)


@pytest.mark.parametrize("steps", [1, 2, 12, 13])
def test_activity_window_step_parity_equals_plain(dev, steps):
    """An odd and an even number of steps: the window ends in either buffer
    of the double-buffered spike bitmap."""
    got, want, _ = _k1_both(dev, 3000, 8, steps)
    _assert_window_equal(got, want)


def test_activity_window_gstep_wraps_past_int32(dev):
    """A window whose global steps cross 2**31 (int32 wrap-around, as the
    reference's traced step counter), with a lesion window that opens at
    the wrap."""
    steps = 13
    chunk = (2 ** 31 - 6) // steps
    start = chunk * steps
    assert start < 2 ** 31 < start + steps
    _, _, _, _, masks = _window_case(dev)
    lesions = (masks[:1], ((-2 ** 31, -2 ** 31 + 30),))
    got, want, _ = _k1_both(dev, 1000, 8, steps, chunk=chunk,
                            lesions=lesions)
    _assert_window_equal(got, want)
    assert not bool(got[0][5][masks[0]].any())


def test_activity_window_non_integer_weights_within_tolerance(dev):
    """Weights that are not integers: the row sums' order differs from
    torch.sum's, so each step from the plain state is held within 1e-5
    relative, and a spike flag may differ only where v sat within 1e-3 of
    the threshold."""
    n, s, steps = 3000, 32, 20
    state, edges, _, rates, _ = _window_case(dev, n=n, s=s, steps=steps,
                                             num_ranks=4)
    g = torch.Generator(device=dev).manual_seed(21)
    w = torch.randn(n, generator=g, device=dev) * 7.3
    kw = dict(seed=3, num_steps=1, izh=_IZH, ca_consts=(1e-4, 2.4e-3))
    st, flips = state, 0
    for t in range(steps):
        args = (st, edges, w, rates, 5.0, 1.0, 40 + t, 1)
        a, _ = af.activity_window(*args, **kw)
        b, _ = af.window_plain(*args, **kw)
        flip = a[5] != b[5]
        v_other = torch.where(a[5], b[0], a[0])[flip]
        assert bool(((v_other - 30.0).abs() < 1e-3).all())
        flips += int(flip.sum())
        same = ~flip
        for x, y in zip(a[:5], b[:5]):
            rel = (x - y).abs()[same] / y.abs()[same].clamp_min(1.0)
            assert float(rel.max()) <= 1e-5
        st = b
    assert flips <= 1e-3 * n * steps


def _streaming_tables(dev, n, chunk=2, steps=5):
    """Stimulus and lesion windows over random masks that open and close
    inside the window of ``chunk``."""
    g = torch.Generator(device=dev).manual_seed(23)
    masks = torch.rand(3, n, generator=g, device=dev) < 0.4
    t = chunk * steps
    return {"stim": (masks[:2].to(torch.float32),
                     ((4.0, t + 1, t + 3), (-2.5, t - 4, 1 << 30))),
            "lesions": (masks[1:], ((t + 2, 1 << 30), (0, t + 4)))}


# (n, S, R, rank, empty share, with events): shapes whose rows do not fit a
# block's shared memory on an H100 (132 SMs, 227 KB a block)
_STREAMING = {
    "R1-S32": (150_000, 32, 1, 0, 0.0, False),
    "R4-rank1-S32": (150_000, 32, 4, 1, 0.0, False),
    "R4-rank1-S17-odd-n": (150_001, 17, 4, 1, 0.0, False),
    "R4-rank1-S8": (262_144, 8, 4, 1, 0.0, False),
    "R4-rank1-S1": (524_288, 1, 4, 1, 0.0, False),
    "R4-rank1-sparse-rows": (150_000, 32, 4, 1, 0.7, False),
    "R1-S32-stimulus-lesions": (150_000, 32, 1, 0, 0.0, True),
}


@pytest.mark.parametrize("case", sorted(_STREAMING))
def test_activity_window_rows_that_do_not_fit_shared_memory(dev, case):
    """A block's rows exceed shared memory, and K1 streams them from global
    memory, bit-equal to the plain version: R = 1 and R = 4 rank 1, S of 32,
    17, 8 and 1, n not a multiple of 32, sparse rows, and stimulus and
    lesion windows opening and closing mid-window."""
    n, s, ranks, rank, empty, events = _STREAMING[case]
    tables = _streaming_tables(dev, n) if events else {}
    got, want, ran = _k1_both(dev, n, s, 5, num_ranks=ranks, rank=rank,
                              empty_share=empty, **tables)
    _assert_window_equal(got, want)
    assert ran == {"staged": 0, "streaming": 1}


def test_activity_window_one_device_launch_per_window(dev):
    """Two 100-step windows at CONFIG's width: two device launches, as
    counted in csrc/activity_window.cu beside the launch."""
    state, edges, w, rates, _ = _window_case(dev, n=65_536, s=32,
                                             steps=100)
    kw = dict(seed=3, num_steps=100, izh=_IZH,
              ca_consts=(1e-4, 2.4e-3))
    af.device_launches(reset=True)
    for chunk in range(2):
        af.activity_window(state, edges, w, rates, 5.0, 1.0, chunk, 0, **kw)
    torch.cuda.synchronize()
    assert af.device_launches(reset=True) == {"staged": 2, "streaming": 0}


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


def _apply_case(dev, n, qm, qr, seed=3):
    g = torch.Generator(device=dev).manual_seed(seed)
    s = 32
    edges = torch.randint(-1, 2 * n, (n, s), generator=g, device=dev,
                          dtype=torch.int32)
    edges = compact(torch.where(torch.rand(n, s, generator=g,
                                           device=dev) < 0.5, -1, edges))
    live = torch.nonzero(edges >= 0)
    pick = live[torch.randint(0, live.shape[0], (qm,), generator=g,
                              device=dev)]
    mgid = edges[pick[:, 0], pick[:, 1]]
    return (edges, pick[:, 0].to(torch.int32), mgid,
            torch.rand(qm, generator=g, device=dev) < 0.9,
            torch.randint(0, n, (qr,), generator=g, device=dev,
                          dtype=torch.int32),
            torch.randint(0, 2 * n, (qr,), generator=g, device=dev,
                          dtype=torch.int32),
            torch.rand(qr, generator=g, device=dev) < 0.9,
            torch.randint(0, 50, (qr,), generator=g, device=dev) / 50.0,
            torch.rand(n, generator=g, device=dev) * 40)


@pytest.mark.parametrize("n", [3000, 65_537, 1 << 20])
@pytest.mark.parametrize("qm,qr", [(4000, 6000), (0, 6000), (4000, 0)])
def test_synapse_apply_sizes_equal_plain(dev, n, qm, qr):
    """n from 3,000 rows to 2**20 (the scan runs over hundreds of blocks'
    ranges), and no messages or no requests at all."""
    args = _apply_case(dev, n, qm, qr)
    got = sa.synapse_apply(*args)
    want = sa.synapse_apply_plain(*args)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_synapse_apply_one_device_launch_per_call(dev):
    """One cooperative launch a call, as counted in csrc/synapse_apply.cu
    beside the launch, over three calls; and the calls are bitwise equal."""
    args = _apply_case(dev, 65_536, 32_768, 20_000)
    sa.device_launches(reset=True)
    outs = [sa.synapse_apply(*args) for _ in range(3)]
    torch.cuda.synchronize()
    assert sa.device_launches(reset=True) == 3
    for o in outs[1:]:
        assert torch.equal(o[0], outs[0][0]) and torch.equal(o[1], outs[0][1])


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


_ADVERSARIAL = {
    "all_equal": [123] * 257,
    "pre_sorted": list(range(3000)),
    "reversed": list(range(3000))[::-1],
    "few_distinct": [1, 0, 2] * 1500,
    "extremes": [2 ** 30 - 1, 0, 2 ** 30 - 1, 5] * 700,
    "single": [7],
}


@pytest.mark.parametrize("name", sorted(_ADVERSARIAL))
@pytest.mark.parametrize("key_bits", [10, 30])
def test_radix_argsort_equals_plain_and_torch_sort(dev, name, key_bits):
    keys = torch.tensor(_ADVERSARIAL[name], dtype=torch.int32, device=dev)
    before = rs.argsort_launches.count
    got = rs.radix_argsort(keys, key_bits=key_bits)
    want = rs.radix_argsort_plain(keys, key_bits=key_bits)
    assert rs.argsort_launches.count == before + 1
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    if key_bits == 30:
        srt = torch.sort(keys, stable=True)
        assert torch.equal(got[0], srt.values)
        assert torch.equal(got[1], srt.indices.to(torch.int32))


@pytest.mark.parametrize("key_bits", [1, 8, 10, 30])
def test_radix_argsort_out_of_range_and_negative_keys(dev, key_bits):
    """Keys above 2**key_bits sort by their low bytes, negative keys by their
    two's-complement bytes, over several tiles."""
    g = torch.Generator(device=dev).manual_seed(8)
    keys = torch.randint(-2 ** 31, 2 ** 31 - 1, (5000,), generator=g,
                         device=dev, dtype=torch.int32)
    got = rs.radix_argsort(keys, key_bits=key_bits)
    want = rs.radix_argsort_plain(keys, key_bits=key_bits)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("n", [1, rs.ARGSORT_TILE - 1, rs.ARGSORT_TILE,
                               rs.ARGSORT_TILE + 1, 77 * rs.ARGSORT_TILE + 3])
@pytest.mark.parametrize("key_bits", [8, 30, 32])
def test_radix_argsort_tiles_and_repeat(dev, n, key_bits):
    """n of 1, one tile +- 1 and many tiles (the look-back crosses dozens):
    bit-equal to the plain version, and a second call bitwise equal."""
    g = torch.Generator(device=dev).manual_seed(n)
    keys = torch.randint(-2 ** 31, 2 ** 31 - 1, (n,), generator=g,
                         device=dev, dtype=torch.int32)
    got = rs.radix_argsort(keys, key_bits=key_bits)
    want = rs.radix_argsort_plain(keys, key_bits=key_bits)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    again = rs.radix_argsort(keys, key_bits=key_bits)
    assert torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])


@pytest.mark.parametrize("key_bits", [1, 10, 30])
def test_radix_argsort_device_launches_per_call(dev, key_bits):
    """One digit-count launch and one onesweep launch a pass, as counted in
    csrc/radix_argsort.cu beside each launch, over two calls."""
    keys = torch.randint(0, 2 ** 30, (100_000,), device=dev,
                         dtype=torch.int32)
    rs.device_launches(reset=True)
    for _ in range(2):
        rs.radix_argsort(keys, key_bits=key_bits)
    torch.cuda.synchronize()
    passes = -(-key_bits // 8)
    assert rs.device_launches(reset=True) == 2 * (1 + passes)


def test_bh_gauss_probs_equals_plain(dev):
    g = torch.Generator(device=dev).manual_seed(9)
    x = torch.rand(300, 3, generator=g, device=dev)
    y = torch.rand(257, 3, generator=g, device=dev)
    w = torch.rand(257, generator=g, device=dev) * 3
    before = bg.launches.count
    p, rsum = bg.bh_gauss_probs(x, y, w, sigma=0.25)
    pp, prs = bg.bh_gauss_plain(x, y, w, sigma=0.25)
    assert bg.launches.count == before + 1
    assert torch.equal(p, pp)
    assert float(((rsum - prs).abs() / prs.abs()).max()) <= 1e-6


@pytest.mark.parametrize("hetero", [False, True])
def test_neuron_step_equals_plain(dev, hetero):
    n = 1031
    g = torch.Generator(device=dev).manual_seed(10)
    args = (torch.randn(n, generator=g, device=dev) * 5 - 60,
            torch.randn(n, generator=g, device=dev) * 2 - 13,
            torch.rand(n, generator=g, device=dev),
            torch.rand(n, generator=g, device=dev) * 2,
            torch.rand(n, generator=g, device=dev) * 2,
            torch.randn(n, generator=g, device=dev) * 5)
    params = None
    if hetero:
        fs = torch.arange(n, device=dev) >= 800
        params = NeuronParams(torch.where(fs, 0.1, 0.02), 0.2,
                              torch.where(fs, -65.0, -50.0), 2.0, 1e-3,
                              torch.where(fs, 0.7, 0.4))
    before = ns.launches.count
    got = ns.neuron_step(*args, SMOKE_CONFIG, params=params)
    want = ns.neuron_step_plain(*args, SMOKE_CONFIG, params=params)
    assert ns.launches.count == before + 1
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("d", [64, 128, 192, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s,skv,causal,window", [
    (200, 200, True, 0), (130, 300, True, 64), (300, 130, False, 0)])
def test_flash_attention_equals_plain(dev, d, dtype, s, skv, causal, window):
    """GQA 3:1 over ragged tiles, Skv above and below S, a window."""
    g = torch.Generator(device=dev).manual_seed(11)
    q = torch.randn(2, 3, s, d, generator=g, device=dev).to(dtype)
    k = torch.randn(2, 1, skv, d, generator=g, device=dev).to(dtype)
    v = torch.randn(2, 1, skv, d, generator=g, device=dev).to(dtype)
    before = fa.launches.count
    got = fa.flash_attention_fwd(q, k, v, causal=causal, window=window)
    want = fa.flash_attention_plain(q, k, v, causal=causal, window=window)
    assert fa.launches.count == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    if dtype == torch.bfloat16:
        lim = fa.bf16_error_bound(want, q, k, v, causal=causal, window=window)
        assert bool(((got.float() - want.float()).abs() <= lim).all())
    else:
        torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_rows_without_a_valid_key(dev, dtype):
    """With a window and Skv < S, rows q >= Skv + window - 1 see no key: the
    kernel gives the full softmax's answer, the mean of V (bf16: the wgmma
    kernel, whose 128-row tiles hold such rows)."""
    g = torch.Generator(device=dev).manual_seed(12)
    q = torch.randn(1, 2, 200, 64, generator=g, device=dev).to(dtype)
    k = torch.randn(1, 2, 70, 64, generator=g, device=dev).to(dtype)
    v = torch.randn(1, 2, 70, 64, generator=g, device=dev).to(dtype)
    got = fa.flash_attention_fwd(q, k, v, causal=True, window=32)
    want = fa.flash_attention_plain(q, k, v, causal=True, window=32)
    mean = v.float().mean(dim=2).to(dtype)
    if dtype == torch.bfloat16:
        lim = fa.bf16_error_bound(want, q, k, v, causal=True, window=32)
        assert bool(((got.float() - want.float()).abs() <= lim).all())
        lim_row = 2.0 ** -7 * mean.float().abs() + 1e-6
        assert bool(((got[:, :, 150].float() - mean.float()).abs()
                     <= lim_row).all())
    else:
        torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)
        torch.testing.assert_close(got[:, :, 150], mean, rtol=2e-5,
                                   atol=2e-5)


@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("ratio", [1, 4, 7])
@pytest.mark.parametrize("s,skv,window", [
    (127, 127, 0), (128, 128, 0), (129, 129, 0), (129, 127, 0),
    (127, 129, 0), (300, 300, 100)])
def test_flash_attention_wgmma_tiles(dev, d, ratio, s, skv, window):
    """The bf16 wgmma kernel around its 128-row / 128-key (64 at D 256)
    tiles, GQA ratios 1, 4 and 7, B = 2 (a tile crossing a head's end
    would read the next head's rows), each element within the bound, and
    a second call bitwise equal."""
    g = torch.Generator(device=dev).manual_seed(s * 1000 + skv + d + ratio)
    bf = torch.bfloat16
    q = torch.randn(2, 2 * ratio, s, d, generator=g, device=dev).to(bf)
    k = torch.randn(2, 2, skv, d, generator=g, device=dev).to(bf)
    v = torch.randn(2, 2, skv, d, generator=g, device=dev).to(bf)
    fa.device_launches(reset=True)
    got = fa.flash_attention_fwd(q, k, v, causal=True, window=window)
    assert fa.device_launches(reset=True)["wgmma_bf16"] == 1
    want = fa.flash_attention_plain(q, k, v, causal=True, window=window)
    lim = fa.bf16_error_bound(want, q, k, v, causal=True, window=window)
    assert bool(((got.float() - want.float()).abs() <= lim).all())
    again = fa.flash_attention_fwd(q, k, v, causal=True, window=window)
    assert torch.equal(got, again)


@pytest.mark.parametrize("d,dtype,kernel", [
    (64, torch.bfloat16, "wgmma_bf16"), (128, torch.bfloat16, "wgmma_bf16"),
    (256, torch.bfloat16, "wgmma_bf16"), (192, torch.bfloat16,
                                          "mma_sync_bf16"),
    (32, torch.bfloat16, "mma_sync_bf16"), (128, torch.float32, "ffma_f32")])
def test_flash_attention_kernel_per_shape(dev, d, dtype, kernel):
    """Each shape launches the kernel ``kernel_for`` names, once, as the
    launches counted in csrc/flash_attention.cu show."""
    q = torch.randn(1, 2, 64, d, device=dev).to(dtype)
    fa.device_launches(reset=True)
    fa.flash_attention_fwd(q, q, q)
    assert fa.device_launches(reset=True) == {
        k: int(k == kernel) for k in fa.KERNELS}


@pytest.mark.parametrize("offset", [1, 8])
def test_flash_attention_wgmma_takes_unaligned_views(dev, offset):
    """TMA needs 16-byte aligned bases: q, k and v that start ``offset``
    bf16 elements into their storage give the aligned inputs' output,
    bitwise, on the wgmma kernel."""
    g = torch.Generator(device=dev).manual_seed(13)
    bf = torch.bfloat16
    n = 2 * 4 * 200 * 128

    def view(heads):
        base = torch.randn(offset + n // 4 * heads, generator=g,
                           device=dev).to(bf)
        return base[offset:].view(2, heads, 200, 128)

    q, k, v = view(4), view(1), view(1)
    assert q.data_ptr() % 16 == 2 * offset % 16
    fa.device_launches(reset=True)
    got = fa.flash_attention_fwd(q, k, v, causal=True)
    assert fa.device_launches(reset=True)["wgmma_bf16"] == 1
    want = fa.flash_attention_fwd(q.clone(), k.clone(), v.clone(),
                                  causal=True)
    assert torch.equal(got, want)
    plain = fa.flash_attention_plain(q, k, v, causal=True)
    lim = fa.bf16_error_bound(plain, q, k, v, causal=True)
    assert bool(((got.float() - plain.float()).abs() <= lim).all())


@pytest.mark.parametrize("d,dtype", [(24, torch.float32), (272, torch.float32),
                                     (64, torch.float16)])
def test_flash_attention_refuses_what_it_does_not_take(dev, d, dtype):
    q = torch.zeros(1, 2, 8, d, device=dev, dtype=dtype)
    with pytest.raises((ValueError, TypeError)):
        fa.flash_attention_fwd(q, q, q)
