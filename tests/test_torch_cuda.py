"""The port's CUDA kernels against their plain versions on the card, at
small sizes. Marked ``cuda``: they skip on a machine without an NVIDIA GPU
(the CPU tests hold the plain versions against the JAX package) and run on
the card with ``python -m pytest -m cuda tests/test_torch_cuda.py``.

Tolerances: the integer kernels (K0, K3-K6, retraction) and the elementwise
float kernels built with --fmad=false in the plain versions' order (K1, K2,
K7's P, K8, the synapse priorities) are bit-equal. K1 sums a row in another
order than ``torch.sum``:
bit-equal with integer weights (the model's), and with non-integer weights
within 1e-5 relative, step-synced, spike flags differing only at near-ties
(|v - 30| < 1e-3), as ``chip_smoke.py`` holds it. K7's row sums are taken in another fixed order: 1e-6
relative. K9 sums in another order with an online softmax: 2e-5 in f32,
the JAX kernel tests' tolerance. In bf16 it also rounds p before P V, and
each element is held within ``flash_attention.bf16_error_bound`` of the
plain version (one bf16 ulp of the output plus the spread of the p
roundings): a fixed 2e-2 would be as large as the output at long rows."""
import dataclasses
import functools
import sys

import pytest
import torch

from repro_torch import prng
from repro_torch.configs.msp_brain import CONFIG, SMOKE_CONFIG
from repro_torch.connectome import synapses as syn
from repro_torch.connectome import traverse
from repro_torch.connectome import tree as ctree
from repro_torch.connectome import update
from repro_torch.connectome.synapses import compact
from repro_torch.core import engine
from repro_torch.core.neuron import NeuronParams
from repro_torch.kernels import activity_fused as af
from repro_torch.kernels import bh_gauss as bg
from repro_torch.kernels import bh_traverse as bt
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import hash as chash
from repro_torch.kernels import neuron_step as ns
from repro_torch.kernels import _build
from repro_torch.kernels import radix_sort as rs
from repro_torch.kernels import retract as kr
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


# --------------------------------------------------- K0's draw kernel
def _k0_case(case, n, dev):
    """(kernel call, plain call) of one prng / threefry_words epilogue at n
    draws, keys batched through a strided view where the call takes a
    batch."""
    g = torch.Generator(device=dev).manual_seed(n)
    words = prng.fold_in_words(prng.key_words(3), n)
    key = prng.key_tensor(words, dev)
    table = torch.randint(0, 2 ** 32, (n, 3), generator=g, device=dev,
                          dtype=torch.int64)
    keys = table[:, 1:]                       # (n, 2), rows 3 apart
    i32 = torch.randint(-2 ** 31, 2 ** 31 - 1, (2 * n,), generator=g,
                        device=dev, dtype=torch.int32)[::2]
    i64 = torch.randint(0, 2 ** 32, (n,), generator=g, device=dev,
                        dtype=torch.int64)
    return {
        "fold_in": (lambda: prng.fold_in(words, i32),
                    lambda: prng.fold_in_plain(key, i32)),
        "fold_in_batch": (lambda: prng.fold_in(keys, i64),
                          lambda: prng.fold_in_plain(keys, i64)),
        "split": (lambda: prng.split(key, n),
                  lambda: prng.split_plain(key, n)),
        "random_bits": (lambda: prng.random_bits(words, (n,), device=dev),
                        lambda: prng.random_bits_plain(key, (n,))),
        "uniform": (lambda: prng.uniform(key, (n, 3)),
                    lambda: prng.uniform_plain(key, (n, 3))),
        "uniform_bounds": (
            lambda: prng.uniform(words, (n, 2), 1.1, 1.5, device=dev),
            lambda: prng.uniform_plain(key, (n, 2), 1.1, 1.5)),
        "uniform_batch": (lambda: prng.uniform(keys),
                          lambda: prng.uniform_plain(keys)),
        "randint": (lambda: prng.randint(words, (n,), -7, 1000, device=dev),
                    lambda: prng.randint_plain(key, (n,), -7, 1000)),
        "threefry_words": (
            lambda: torch.stack(chash.threefry_words(i32, 0x9E3779B9, i64,
                                                     keys[:, 0])),
            lambda: torch.stack(chash.threefry2x32(i32, 0x9E3779B9, i64,
                                                   keys[:, 0]))),
    }[case]


@pytest.mark.parametrize("n", [1, 3, 65537])
@pytest.mark.parametrize("case", [
    "fold_in", "fold_in_batch", "split", "random_bits", "uniform",
    "uniform_bounds", "uniform_batch", "randint", "threefry_words"])
def test_draw_kernel_equals_plain_in_one_launch(dev, case, n):
    """Each epilogue of K0's draw kernel is bit-equal to its plain version
    and is one device launch a call (the wrapper's count and the count in
    csrc/hash_words.cu)."""
    kernel, plain = _k0_case(case, n, dev)
    torch.cuda.synchronize()
    before = chash.launches.count
    chash.device_launches(reset=True)
    got = kernel()
    torch.cuda.synchronize()
    assert chash.launches.count == before + 1
    assert chash.device_launches(reset=True) == 1
    want = plain()
    assert chash.device_launches(reset=True) == 0
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(got, want)


def test_reference_priorities_are_three_draw_launches(dev):
    """The reference lowering's ``edge_priority`` (fold_in, fold_in,
    uniform) is three launches of the draw kernel, bit-equal to the
    plain composition and to the fused priority kernel."""
    g = torch.Generator(device=dev).manual_seed(4)
    a = torch.randint(0, 1 << 20, (70000,), generator=g, device=dev,
                      dtype=torch.int32)
    b = torch.randint(0, 1 << 20, (70000,), generator=g, device=dev,
                      dtype=torch.int32)
    words = prng.split_words(prng.fold_in_words(prng.key_words(2), 7), 3)[0]
    before = chash.launches.count
    got = syn.edge_priority(words, a, b)
    assert chash.launches.count == before + 3
    key = prng.key_tensor(words, dev)
    want = prng.uniform_plain(prng.fold_in_plain(prng.fold_in_plain(key, a),
                                                 b))
    assert torch.equal(got, want)
    assert torch.equal(got, kr.edge_priority(words, a, b))


def test_words_key_without_device_lands_on_the_card(dev):
    """A key of words with no tensor operand and no ``device`` draws on the
    card (``device.resolve_device``), one launch, equal to the plain
    version."""
    words = prng.fold_in_words(prng.key_words(8), 1)
    before = chash.launches.count
    got = prng.uniform(words, (5, 3))
    assert got.is_cuda and chash.launches.count == before + 1
    assert torch.equal(got, prng.uniform_plain(prng.key_tensor(words, dev),
                                               (5, 3)))


def test_draw_kernel_rejects_what_no_stride_reads(dev):
    """An operand of 1- or 2-byte integers, or one that no two strides read
    over the output (a (4, 1, 5) block broadcast over (4, 3, 5)), raises
    instead of being copied; nothing is launched. A row or a column
    broadcast over a grid is two strides: read where it lies, bit-equal."""
    before = chash.launches.count
    with pytest.raises(TypeError):
        chash.threefry_words(torch.zeros(4, dtype=torch.int16, device=dev),
                             1, 2, 3)
    block = torch.zeros(4, 1, 5, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):
        chash.threefry_words(block, 1,
                             torch.zeros(4, 3, 5, dtype=torch.int32,
                                         device=dev), 3)
    with pytest.raises(ValueError):
        chash.gumbel(1, 2, block, torch.zeros(1, 3, 1, device=dev,
                                              dtype=torch.int64))
    assert chash.launches.count == before
    col = torch.arange(4, dtype=torch.int32, device=dev)[:, None] * 7
    row = torch.arange(5, dtype=torch.int64, device=dev)[None, :] + 2 ** 33
    grid = torch.arange(20, dtype=torch.int32, device=dev).reshape(4, 5)
    for a, b in ((row, col), (col, row), (grid.t().contiguous().t(), row)):
        for x, y in zip(chash.threefry_words(a, 1, b, grid),
                        chash.threefry2x32(a, 1, b, grid)):
            assert torch.equal(x, y)
    assert chash.launches.count == before + 3


def _hash_draw_cases(n, dev):
    """(kernel call, plain call) of the counter-hash draws: phase A's and
    phase B's Gumbel (a (Q, 1) gid column against a (1, F) counter row),
    the activity window's noise (NORMAL over (n,) gids) and its remote
    spike uniforms (UNIT over (n, S) edge ids)."""
    g = torch.Generator(device=dev).manual_seed(n)
    gids = torch.randint(0, 2 ** 31 - 1, (n,), generator=g, device=dev,
                         dtype=torch.int32)
    ctr = chash.bh_ctr(5, 3, torch.arange(64, device=dev))[None, :]
    edge_id = (gids.to(torch.int64)[:, None] * 8
               + torch.arange(8, device=dev))
    seed, dom = 0x12345, chash.BH_DOMAIN
    return {
        "gumbel": (lambda: chash.gumbel(seed, dom, ctr, gids[:, None]),
                   lambda: chash.gumbel_plain(seed, dom, ctr, gids[:, None])),
        "normal": (lambda: chash.normal(seed, chash.NOISE_DOMAIN, 2 ** 31 + 9,
                                        gids.to(torch.int64)),
                   lambda: chash.normal_plain(seed, chash.NOISE_DOMAIN,
                                              2 ** 31 + 9,
                                              gids.to(torch.int64))),
        "uniform": (lambda: chash.uniform(seed, chash.SPIKE_DOMAIN, 77,
                                          edge_id),
                    lambda: chash.uniform_plain(seed, chash.SPIKE_DOMAIN, 77,
                                                edge_id)),
    }


@pytest.mark.parametrize("n", [1, 3, 4099, 65537])
@pytest.mark.parametrize("case", ["gumbel", "normal", "uniform"])
def test_counter_hash_draws_equal_plain_in_one_launch(dev, case, n):
    """K0's GUMBEL, NORMAL and UNIT epilogues at odd sizes (the Gumbel in
    the outer layout of a column against a row): bit-equal to the plain
    int64 composition, one device launch a call."""
    kernel, plain = _hash_draw_cases(n, dev)[case]
    torch.cuda.synchronize()
    chash.device_launches(reset=True)
    got = kernel()
    torch.cuda.synchronize()
    assert chash.device_launches(reset=True) == 1
    chash.plain_cuda_calls(reset=True)
    want = plain()
    assert chash.plain_cuda_calls(reset=True) == 1
    assert got.dtype == want.dtype == torch.float32
    assert got.shape == want.shape and torch.equal(got, want)


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


def _one_launch_twice(fn, device_launches, monkeypatch, module, plain):
    """``fn()`` twice under the sync debug mode "error" (no host wait), with
    ``module.plain`` replaced by a function that fails (a CUDA tensor never
    runs the plain version). Returns both results and the device launches
    counted in the source."""
    def refuse(*args, **kw):
        raise AssertionError(f"{plain} ran on a CUDA tensor")
    _build.library()
    torch.cuda.synchronize()
    device_launches(reset=True)
    with monkeypatch.context() as mp:
        mp.setattr(module, plain, refuse)
        torch.cuda.set_sync_debug_mode("error")
        try:
            first, second = fn(), fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    return first, second, device_launches(reset=True)


def _morton_case(dev, case):
    """(positions, leaf_base, leaf_level, n_leaf) of a K3 case."""
    g = torch.Generator(device=dev).manual_seed(2)
    n = 5000
    if case == "config":                    # the main path's shape
        pos = engine.init_state(CONFIG, 0, 1, device=dev).positions
        leaf_level, n_leaf, base_cell = ctree._tree_geometry(0, CONFIG, 1)
        return pos, base_cell * 8 ** CONFIG.local_levels, leaf_level, n_leaf
    if case == "one_cell":                  # every neuron in one cell
        return (torch.full((65_536, 3), 0.3, device=dev), 0, 4, 4096)
    pos = torch.rand(n, 3, generator=g, device=dev)
    if case == "clustered":
        pos = torch.clamp(pos * 1e-3 + 0.3, 0.0, 1.0 - 1e-6)
    if case == "clamped":    # R = 4, rank 2: most cells below or above
        return pos, 2 * 2 * 8 ** 4, 5, 2 * 8 ** 4
    if case.startswith("leaf_"):   # (leaf level, n_leaf, base) at R = 1, 4
        level, n_leaf, base = {"leaf_8^3": (3, 8 ** 3, 0),
                               "leaf_8^4": (4, 8 ** 4, 0),
                               "leaf_2x8^4": (5, 2 * 8 ** 4, 2 * 8 ** 4),
                               "leaf_8^5": (5, 8 ** 5, 0)}[case]
        return torch.rand(65_536, 3, generator=g, device=dev), base, level, \
            n_leaf
    if case == "windows":    # R = 9, local_levels 5: 7 x 8^5 cells
        pos = torch.rand(65_536, 3, generator=g, device=dev)
        return pos, 3 * 7 * 8 ** 5, 7, 7 * 8 ** 5
    if case == "n_below_grid":
        return pos[:50].contiguous(), 0, 4, 4096
    if case == "odd_cells":                 # rows padded to 4 cells
        return pos, 100, 4, 1001
    return pos, 512, 4, 2048


@pytest.mark.parametrize("case", [
    "uniform", "clustered", "config", "one_cell", "clamped", "leaf_8^3",
    "leaf_8^4", "leaf_2x8^4", "leaf_8^5", "windows", "n_below_grid",
    "odd_cells"])
def test_morton_sort_equals_plain(dev, monkeypatch, case):
    """Bit-equal to the plain version, one device launch a call (counted in
    csrc/morton_sort.cu), a second call bitwise equal, no host wait: random
    and clustered positions, CONFIG's, all 65,536 neurons in one cell,
    positions clamped below 0 and above n_leaf - 1 (R = 4, rank 2), n_leaf
    8^3 to 8^5 and 7 x 8^5 (several histogram windows), n below the grid,
    an n_leaf that is not a multiple of 4."""
    pos, base, leaf_level, n_leaf = _morton_case(dev, case)
    kw = dict(leaf_level=leaf_level, n_leaf=n_leaf)
    before = rs.launches.count
    got, again, launched = _one_launch_twice(
        lambda: rs.morton_sort(pos, base, **kw), rs.morton_device_launches,
        monkeypatch, rs, "morton_sort_plain")
    assert rs.launches.count == before + 2
    assert launched == 2
    want = rs.morton_sort_plain(pos, base, **kw)
    for a, b, c in zip(got, want, again):
        assert torch.equal(a, b) and torch.equal(a, c)


def test_morton_sort_refuses_more_cells_than_its_keys_hold(dev):
    pos = torch.rand(100, 3, device=dev)
    with pytest.raises(ValueError, match=str(rs.MORTON_MAX_CELLS)):
        rs.morton_sort(pos, 0, leaf_level=8, n_leaf=rs.MORTON_MAX_CELLS + 1)


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


# K5 cases: (entries m, n, num_ranks, cap, what the partner gids are)
_ROUTE_CASES = {
    "r1": (3000 * 32, 3000, 1, 4096, "half"),
    "r1_cap_above_totals": (3000 * 32, 3000, 1, 1 << 20, "half"),
    "r3": (3000 * 32, 3000, 3, 900, "half"),
    "r64": (1000 * 32, 1000, 64, 200, "half"),
    "r64_cap_above_totals": (1000 * 32, 1000, 64, 10_000, "half"),
    "check_k5": (65_536 * 32, 65_536, 1, 32_768, "half"),
    "all_invalid": (3000 * 32, 3000, 3, 900, "invalid"),
    "one_destination": (3000 * 32, 3000, 3, 900, "one"),   # cap below it
    "m_ragged": (99_991, 3000, 3, 20_000, "half"),
    "m_below_grid": (50, 10, 1, 8, "half"),
    "m_beyond_shared_memory": (9_000_001, 300_000, 1, 1 << 23, "half"),
    "unaligned": (3000 * 32 + 1, 3000, 3, 900, "unaligned"),
    "n_one": (5000, 1, 3, 900, "half"),       # a rank of one neuron
}


def _route_case(dev, m, n, num_ranks, kind):
    g = torch.Generator(device=dev).manual_seed(4)
    other = torch.randint(0, num_ranks * n, (m,), generator=g, device=dev,
                          dtype=torch.int32)
    if kind == "one":
        other = other % n + (num_ranks - 1) * n
    elif kind == "invalid":
        other = torch.full_like(other, -1)
    else:
        other = torch.where(torch.rand(m, generator=g, device=dev) < 0.5,
                            -1, other)
    mine = torch.arange(m, device=dev, dtype=torch.int32) // 32
    if kind == "unaligned":                 # views 4 bytes into their storage
        return other[1:], mine[1:]
    return other, mine


@pytest.mark.parametrize("case", sorted(_ROUTE_CASES))
def test_route_build_equals_plain(dev, monkeypatch, case):
    """Bit-equal to the plain version, one device launch a call (counted in
    csrc/synapse_apply.cu), a second call bitwise equal, no host wait: R 1,
    3 and 64; caps above every total and below a destination's count; every
    entry invalid; every entry to one destination; m not a multiple of a
    block's range, below the grid's block count and beyond what the grid's
    shared memory holds; operands 4 bytes off their storage's alignment; a
    rank of one neuron (the gid is the rank)."""
    m, n, ranks, c, kind = _ROUTE_CASES[case]
    other, mine = _route_case(dev, m, n, ranks, kind)
    kw = dict(n=n, num_ranks=ranks, cap=c)
    before = sa.route_launches.count
    got, again, launched = _one_launch_twice(
        lambda: sa.route_build(other, mine, **kw), sa.route_device_launches,
        monkeypatch, sa, "route_build_plain")
    assert sa.route_launches.count == before + 2
    assert launched == 2
    want = sa.route_build_plain(other, mine, **kw)
    for a, b, d in zip(got, want, again):
        assert torch.equal(a, b) and torch.equal(a, d)


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


def _k8_params(variant, n, dev):
    fs = torch.arange(n, device=dev) >= n // 2
    if variant == "homogeneous":
        return None
    if variant == "heterogeneous":
        return NeuronParams(torch.where(fs, 0.1, 0.02),
                            torch.full((n,), 0.2, device=dev),
                            torch.where(fs, -65.0, -50.0),
                            torch.full((n,), 2.0, device=dev),
                            torch.full((n,), 1e-3, device=dev),
                            torch.where(fs, 0.7, 0.4))
    return NeuronParams(torch.where(fs, 0.1, 0.02), 0.2,
                        torch.tensor(-55.0, device=dev), 2.0,
                        torch.full((n,), 1e-3, device=dev),
                        torch.where(fs, 0.7, 0.4))


@pytest.mark.parametrize("n", [1, 3, 65537])
@pytest.mark.parametrize("variant", ["homogeneous", "heterogeneous", "mixed"])
@pytest.mark.parametrize("offset", [0, 1])
def test_neuron_step_odd_sizes_equal_plain(dev, n, variant, offset):
    """K8 at odd n (the float4 loop and its scalar tail), with all-scalar,
    all-array and mixed parameters (a 0-dim tensor among them), on aligned
    inputs and on views one element off alignment (the one-a-thread loop):
    bit-equal to the plain version, one launch a call."""
    g = torch.Generator(device=dev).manual_seed(n)
    state = [torch.randn(n + 1, generator=g, device=dev)[offset:offset + n]
             for _ in range(6)]
    v, u, ca, ax, de, inp = state
    args = (v * 5 - 60, u * 2 - 13, ca.abs() * 0.01, ax.abs() * 2,
            de.abs() * 2, inp * 20)
    if offset:   # keep the views off alignment
        args = [torch.empty(n + 1, device=dev)[1:].copy_(x) for x in args]
    params = _k8_params(variant, n, dev)
    before = ns.launches.count
    got = ns.neuron_step(*args, SMOKE_CONFIG, params=params)
    assert ns.launches.count == before + 1
    want = ns.neuron_step_plain(*args, SMOKE_CONFIG, params=params)
    assert got[5].dtype == torch.bool
    for a, b in zip(got, want):
        assert a.shape == (n,) and torch.equal(a, b)


@pytest.mark.parametrize("kind", ["f32_on_card", "f64_on_card", "cpu"])
def test_neuron_step_sees_parameters_changed_in_place(dev, kind):
    """The wrapper reads the parameters on every call: a change made in
    place to an (n,) parameter between two calls with the same ``params``
    object shows in the second, for a parameter the kernel reads where it
    lies and for one the wrapper copies."""
    n = 1027
    g = torch.Generator(device=dev).manual_seed(5)
    args = (torch.randn(n, generator=g, device=dev) * 5 - 60,
            torch.randn(n, generator=g, device=dev) * 2 - 13,
            torch.rand(n, generator=g, device=dev) * 0.01,
            torch.rand(n, generator=g, device=dev) * 2,
            torch.rand(n, generator=g, device=dev) * 2,
            torch.randn(n, generator=g, device=dev) * 20)
    a = {"f32_on_card": torch.full((n,), 0.02, device=dev),
         "f64_on_card": torch.full((n,), 0.02, device=dev,
                                   dtype=torch.float64),
         "cpu": torch.full((n,), 0.02)}[kind]
    params = NeuronParams(a, 0.2, -65.0, 2.0, 1e-3, 0.7)
    first = ns.neuron_step(*args, SMOKE_CONFIG, params=params)
    a[n // 2:] = 0.1
    second = ns.neuron_step(*args, SMOKE_CONFIG, params=params)
    fresh = NeuronParams(a.to(dev, torch.float32), 0.2, -65.0, 2.0, 1e-3,
                         0.7)
    want = ns.neuron_step_plain(*args, SMOKE_CONFIG, params=fresh)
    for x, y in zip(second, want):
        assert torch.equal(x, y)
    assert not torch.equal(first[1], second[1])


def test_neuron_step_rejects_what_it_does_not_take(dev):
    """A non-f32 input, a CPU input beside CUDA ones and (n,) parameters of
    another n raise; nothing is launched."""
    x = torch.zeros(64, device=dev)
    before = ns.launches.count
    with pytest.raises(TypeError):
        ns.neuron_step(x, x, x, x, x.double(), x, SMOKE_CONFIG)
    with pytest.raises(ValueError):
        ns.neuron_step(x, x, x, x, x, x.cpu(), SMOKE_CONFIG)
    with pytest.raises(ValueError):
        ns.neuron_step(x, x, x, x, x, x, SMOKE_CONFIG,
                       params=_k8_params("heterogeneous", 65, dev))
    assert ns.launches.count == before


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


# ---------------------------------------------- retraction and priorities
def _retract_case(dev, case, n=CONFIG.neurons_per_rank,
                  s=CONFIG.max_synapses):
    """Rows at CONFIG's shape: full random rows, the scenario's sparse rows
    (about 0.25 synapses a neuron), lesion rows (n_delete at or above the
    count) and rows holding partners twice (tied priorities)."""
    g = torch.Generator(device=dev).manual_seed(len(case))
    i32 = torch.int32
    part = torch.randint(0, n, (n, s), generator=g, device=dev, dtype=i32)
    hole = torch.rand(n, s, generator=g, device=dev)
    nd = torch.randint(0, s + 1, (n,), generator=g, device=dev, dtype=i32)
    if case == "full":
        edges = part
    elif case == "sparse":
        edges = torch.where(hole < 0.25 / s, part, -1)
        nd = torch.randint(0, 2, (n,), generator=g, device=dev, dtype=i32)
    elif case == "lesion":
        edges = torch.where(hole < 0.5, part, -1)
        nd = (edges >= 0).sum(1, dtype=i32) + nd % 3
    else:
        edges = torch.where(hole < 0.2, -1, part % 3 + torch.arange(
            n, device=dev, dtype=i32)[:, None])
    return edges, nd, torch.arange(n, dtype=i32, device=dev) + 7


@pytest.mark.parametrize("case", ["full", "sparse", "lesion", "duplicates"])
def test_retract_equals_plain(dev, case):
    edges, nd, gids = _retract_case(dev, case)
    words = prng.split_words(prng.fold_in_words(prng.key_words(5), 3), 3)[0]
    before = kr.retract_launches.count
    got = kr.retract(words, edges, nd, gids)
    assert kr.retract_launches.count == before + 1
    want = syn.retract_synapses(prng.key_tensor(words, dev), edges, nd, gids)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert got[1].dtype == torch.bool
    if case != "sparse":
        assert bool(got[1].any())


@pytest.mark.parametrize("s", [1, 8, 17])
def test_retract_narrow_rows_equal_plain(dev, s):
    edges, nd, gids = _retract_case(dev, "duplicates", n=4099, s=s)
    words = (0x12345678, 0x9ABCDEF0)
    got = kr.retract(words, edges, nd, gids)
    want = syn.retract_synapses(prng.key_tensor(words, dev), edges, nd, gids)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("with_valid", [False, True])
def test_edge_priority_equals_plain(dev, with_valid):
    q, n = CONFIG.neurons_per_rank, CONFIG.neurons_per_rank
    g = torch.Generator(device=dev).manual_seed(4)
    a = torch.randint(-3, n, (q,), generator=g, device=dev,
                      dtype=torch.int32)
    b = torch.randint(0, n, (q,), generator=g, device=dev, dtype=torch.int32)
    valid = torch.rand(q, generator=g, device=dev) < 0.6
    words = prng.split_words(prng.fold_in_words(prng.key_words(2), 7), 3)[2]
    key = prng.key_tensor(words, dev)
    before = kr.priority_launches.count
    if with_valid:
        got = kr.edge_priority(words, a, b, valid)
        want = syn.request_priority(key, b, a, valid)
    else:
        got = kr.edge_priority(words, a, b)
        want = syn.edge_priority(key, a, b)
    assert kr.priority_launches.count == before + 1
    assert torch.equal(got, want)


def test_retraction_does_not_wait_for_the_card(dev):
    """``update._retraction`` with all five lowerings fused, after two
    chunks of the lesion scenario, under the sync debug mode: nothing in it
    copies a Python scalar to the card or reads one back."""
    scn = dataclasses.replace(library.lesion_rewiring(),
                              events=(Lesion("core", t=150),))
    cfg = dataclasses.replace(
        library.SMOKE_SCENARIO_CONFIG, activity_impl="fused",
        connectivity_impl="fused", tree_impl="fused", apply_impl="fused")
    sim = Simulator.from_config(cfg, scenario=scn, device=dev)
    sim.run(2)
    state, n = sim.state, cfg.neurons_per_rank
    gids = torch.arange(n, dtype=torch.int32, device=dev)
    k_out, k_in, _ = prng.split_words(
        prng.fold_in_words(prng.key_words(cfg.seed + 2), state.chunk), 3)
    _build.library()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with pytest.raises(RuntimeError):
            torch.tensor(1, device=dev)        # the mode flags a copy
        out_e, in_e, _ = update._retraction(state, sim.ctx, gids, k_out,
                                            k_in, state.stats)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert out_e.shape == in_e.shape == (n, cfg.max_synapses)


def _cuda_calls(fn, names):
    """Run ``fn`` and count the calls of the functions ``names`` (code
    objects) that received a CUDA tensor."""
    seen = {c: 0 for c in names}

    def hook(frame, event, arg):
        if event == "call" and frame.f_code in seen:
            if any(isinstance(v, torch.Tensor) and v.is_cuda
                   for v in frame.f_locals.values()):
                seen[frame.f_code] += 1

    sys.setprofile(hook)
    try:
        fn()
    finally:
        sys.setprofile(None)
    return {names[c]: k for c, k in seen.items()}


@pytest.mark.parametrize("impl", ["reference", "fused"])
def test_plain_priorities_run_only_in_the_reference_lowering(dev, impl):
    """With all five lowerings fused, retraction and the acceptance draw run
    their kernels: ``retract_synapses``, ``edge_priority`` and the plain
    int64 Threefry see no CUDA tensor; the reference lowering runs them."""
    scn = dataclasses.replace(library.lesion_rewiring(),
                              events=(Lesion("core", t=150),))
    cfg = dataclasses.replace(
        library.SMOKE_SCENARIO_CONFIG, activity_impl=impl,
        connectivity_impl=impl, tree_impl=impl, apply_impl=impl)
    names = {syn.retract_synapses.__code__: "retract_synapses",
             syn.edge_priority.__code__: "edge_priority",
             chash.threefry2x32.__code__: "threefry2x32"}
    sim = Simulator.from_config(cfg, scenario=scn, device=dev)
    calls = _cuda_calls(lambda: sim.run(3), names)
    # the plain int64 Threefry sees no CUDA tensor on either lowering: the
    # reference's draws (prng, and hash's uniform, gumbel and normal) are
    # launches of K0's draw kernel on the card
    if impl == "fused":
        assert calls == {"retract_synapses": 0, "edge_priority": 0,
                         "threefry2x32": 0}
    else:
        assert calls["threefry2x32"] == 0, calls
        assert calls["retract_synapses"] > 0 and calls["edge_priority"] > 0


def test_init_state_on_the_card_equals_the_cpu(dev):
    """``init_state``'s draws run K0's kernel on the card (through
    ``prng``) and give the CPU's bits."""
    cfg = dataclasses.replace(SMOKE_CONFIG, neurons_per_rank=4099)
    before = chash.launches.count
    chash.device_launches(reset=True)
    a = engine.init_state(cfg, 0, 1, device=dev)
    assert chash.launches.count == before + 3     # randint, two uniforms
    assert chash.device_launches(reset=True) == 3
    b = engine.init_state(cfg, 0, 1, device="cpu")
    assert torch.equal(a.positions.cpu(), b.positions)
    for x, y in zip(a.neurons, b.neurons):
        assert torch.equal(x.cpu(), y)


# ------------------------------------------------------ K2 on synthetic trees
def _synthetic_tree(dev, w0, levels, m, empty_share, seed):
    """A consistent stacked tree: level k holds w0 8^k cells; leaf counts
    random with whole 8-leaf and 64-leaf subtrees empty, centroid sums
    count x a random point; inner levels the sums of their 8 children.
    Returns (counts (L, C), cents (L, C, 3), widths, members (n_leaf, m),
    npos, vac)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    n_leaf = w0 * 8 ** (levels - 1)
    cnt = torch.rand(n_leaf, generator=g, device=dev) * 3
    for block in (8, 64):
        drop = torch.rand(n_leaf // block + 1, generator=g, device=dev) \
            < empty_share
        cnt = torch.where(drop.repeat_interleave(block)[:n_leaf], 0.0, cnt)
    cent = cnt[:, None] * torch.rand(n_leaf, 3, generator=g, device=dev)
    counts, cents = [cnt], [cent]
    for _ in range(levels - 1):
        counts.insert(0, counts[0].reshape(-1, 8).sum(1))
        cents.insert(0, cents[0].reshape(-1, 8, 3).sum(1))
    stacked = traverse.stack_levels(tuple(counts), tuple(cents), 0)
    n = 5000
    members = torch.randint(-1, n, (n_leaf, m), generator=g, device=dev,
                            dtype=torch.int32)
    npos = torch.rand(n, 3, generator=g, device=dev)
    vac = torch.rand(n, generator=g, device=dev) * 4
    return stacked, tuple(c.shape[0] for c in counts), members, npos, vac


def _k2_compare(dev, w0, levels, f, m, empty_share, use_widths, q=3000,
                seed=0):
    stacked, widths, members, npos, vac = _synthetic_tree(
        dev, w0, levels, m, empty_share, seed)
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    x = torch.rand(q, 3, generator=g, device=dev)
    start = torch.randint(0, w0, (q,), generator=g, device=dev,
                          dtype=torch.int32)
    gids = torch.randint(0, 5000, (q,), generator=g, device=dev,
                         dtype=torch.int32)
    valid = torch.rand(q, generator=g, device=dev) < 0.8
    sizes = tuple(0.5 ** (2 + k) for k in range(levels))
    kw = dict(seed=11, sizes=sizes, theta=0.3, sigma=0.2, frontier=f,
              n_levels=levels)
    args = (stacked.counts, stacked.centroids, members, npos, vac, x, start,
            gids, valid, 9, 0)
    got = bt.bh_traverse(*args, **kw,
                         widths=widths if use_widths else None)
    want = traverse.phase_b_core(*args, **kw)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert bool(want[1].any()) and bool((want[2] > 1).any())


@pytest.mark.parametrize("m", [1, 4, 32])
@pytest.mark.parametrize("f", [8, 64, 128])
def test_bh_traverse_frontier_and_members_equal_plain(dev, f, m):
    _k2_compare(dev, w0=8, levels=4, f=f, m=m, empty_share=0.2,
                use_widths=True)


def test_bh_traverse_empty_subtrees_equal_plain(dev):
    _k2_compare(dev, w0=8, levels=4, f=64, m=8, empty_share=0.7,
                use_widths=True, seed=3)


@pytest.mark.parametrize("use_widths", [False, True])
def test_bh_traverse_tree_beyond_shared_memory_equals_plain(dev, use_widths):
    """16 x 4,681 packed nodes (1.2 MB): most levels are read through
    __ldg; without widths every level packs all C cells."""
    _k2_compare(dev, w0=16, levels=5, f=64, m=8, empty_share=0.2,
                use_widths=use_widths, seed=5)


# ------------------------------------------------------------ R ranks
def test_local_comm_collectives_stay_on_the_card(dev):
    """``dist.LocalComm``'s exchanges are tensor ops on the card: no copy
    to the host and no wait for the stream (the sync debug mode raises on
    either), every rank's result on the card."""
    from repro_torch import dist
    group = dist.LocalComm(4)

    def body(r):
        c = group.comm(r)
        buf = torch.full((4, 5, 2), r, dtype=torch.int32, device=dev)
        return (c.all_to_all(buf), c.all_gather(buf[0]),
                c.psum(buf[0, 0].float()))

    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        # the mode sees a wait inside a rank's thread
        with pytest.raises(RuntimeError):
            group.run([lambda: torch.ones(1, device=dev).item()] * 4,
                      device=dev)
        out = group.run([lambda r=r: body(r) for r in range(4)], device=dev)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    for d, (a2a, ag, ps) in enumerate(out):
        assert a2a.is_cuda and ag.is_cuda and ps.is_cuda
        assert a2a[:, :, 0].tolist() == [[s] * 5 for s in range(4)]
        assert ag.shape == (20, 2) and ps.tolist() == [6.0, 6.0]


@pytest.mark.parametrize("num_ranks", [2, 4])
def test_multi_rank_fused_equals_reference_on_the_card(dev, num_ranks):
    """R ranks in one process (``dist.LocalComm``) through a lesion: all
    five fused lowerings equal the reference bitwise, health 0, the out- and
    in-tables symmetric over all ranks, a second fused run bitwise equal."""
    scn = library.lesion_rewiring()
    scn = dataclasses.replace(scn, events=tuple(
        dataclasses.replace(e, t=e.t // 5) for e in scn.events))
    out = []
    for impl in ("reference", "fused", "fused"):
        cfg = dataclasses.replace(
            library.SMOKE_SCENARIO_CONFIG, activity_impl=impl,
            connectivity_impl=impl, tree_impl=impl, apply_impl=impl)
        sim = Simulator.from_config(cfg, scenario=scn, device=dev,
                                    num_ranks=num_ranks)
        sim.run(4)
        assert sim.health()["health_flags"] == 0.0
        out.append((sim.state, sim.stats()))
    for st, stats in out[1:]:
        assert torch.equal(st.in_edges, out[0][0].in_edges)
        assert torch.equal(st.out_edges, out[0][0].out_edges)
        for f in st.neurons._fields:
            assert torch.equal(getattr(st.neurons, f),
                               getattr(out[0][0].neurons, f)), f
        assert {k: v for k, v in stats.items() if "launches/" not in k} == \
            {k: v for k, v in out[0][1].items() if "launches/" not in k}
    st = out[1][0]
    rows = torch.arange(st.out_edges.shape[0], device=dev)[:, None] \
        .expand_as(st.out_edges)
    mo, mi = st.out_edges >= 0, st.in_edges >= 0
    n_all = st.out_edges.shape[0]
    assert torch.equal(
        torch.sort(rows[mo] * n_all + st.out_edges[mo].long()).values,
        torch.sort(st.in_edges[mi].long() * n_all + rows[mi]).values)
    assert out[1][1]["synapses_deleted"] > 0


@pytest.mark.parametrize("rank", [0, 3])
def test_kernels_at_a_rank_of_four_equal_plain(dev, rank):
    """K3 at the rank's geometry (two branch cells, base cell 2 x rank), K5
    into four buckets with partner gids on every rank, and K2 with gid_base
    rank x n over R x cap query slots, about half invalid: bit-equal to the
    plain versions."""
    from repro_torch.connectome import routing
    from repro_torch.core import morton
    r_all = 4
    cfg = dataclasses.replace(CONFIG, neurons_per_rank=8192)
    n, s = cfg.neurons_per_rank, cfg.max_synapses
    st = engine.init_state(cfg, rank, r_all, device=dev)
    # K3
    leaf_level, n_leaf, base_cell = ctree._tree_geometry(rank, cfg, r_all)
    kw3 = dict(leaf_level=leaf_level, n_leaf=n_leaf)
    base = base_cell * 8 ** cfg.local_levels
    for a, b in zip(rs.morton_sort(st.positions, base, **kw3),
                    rs.morton_sort_plain(st.positions, base, **kw3)):
        assert torch.equal(a, b)
    # K5
    g = torch.Generator(device=dev).manual_seed(rank)
    other = torch.randint(0, r_all * n, (n * s,), generator=g, device=dev,
                          dtype=torch.int32)
    other = torch.where(torch.rand(n * s, generator=g, device=dev) < 0.5,
                        -1, other)
    mine = rank * n + torch.arange(n * s, device=dev,
                                   dtype=torch.int32) // s
    kw5 = dict(n=n, num_ranks=r_all, cap=routing.cap_deletions(cfg, True))
    got = sa.route_build(other, mine, **kw5)
    want = sa.route_build_plain(other, mine, **kw5)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert bool((got[0][:, :, 0] >= 0).any(1).all())
    # K2
    b = morton.branch_level(r_all)
    tree = ctree.build_local_tree(st.positions, st.neurons.de_elements, rank,
                                  cfg, r_all)
    stacked = traverse.stack_levels(tree.counts, tree.centroids, b)
    cap = routing.cap_requests(cfg, r_all)
    q = r_all * cap
    x = torch.zeros(q, 3, device=dev)
    src = torch.full((q,), -2, dtype=torch.int32, device=dev)
    valid_rows = torch.rand(q, generator=g, device=dev) < 0.5
    x[valid_rows] = torch.rand(int(valid_rows.sum()), 3, generator=g,
                               device=dev)
    src[valid_rows] = torch.randint(0, r_all * n, (int(valid_rows.sum()),),
                                    generator=g, device=dev,
                                    dtype=torch.int32)
    start = torch.randint(0, 2, (q,), generator=g, device=dev,
                          dtype=torch.int32) * valid_rows
    kw2 = dict(seed=cfg.seed, sizes=stacked.sizes, theta=cfg.theta,
               sigma=cfg.sigma, frontier=cfg.frontier_cap,
               n_levels=cfg.local_levels + 1)
    args = (stacked.counts, stacked.centroids, tree.leaf_members,
            st.positions, st.neurons.de_elements, x, start, src, valid_rows,
            2, rank * n)
    got = bt.bh_traverse(*args, **kw2,
                         widths=tuple(c.shape[0] for c in tree.counts))
    want = traverse.phase_b_core(*args, **kw2)
    for a, b2 in zip(got, want):
        assert torch.equal(a, b2)
    assert bool(want[1].any())


def test_process_group_comm_over_nccl_with_one_rank(dev):
    """``dist.ProcessGroupComm`` on NCCL in a group of one rank (the card
    here is one): its three collectives on card tensors, and two chunks of
    the simulator through it bitwise equal to the one-rank simulator (NCCL
    across cards stays unverified)."""
    import socket
    import torch.distributed as tdist
    from repro_torch import dist
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    tdist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                             world_size=1, rank=0)
    try:
        comm = dist.ProcessGroupComm()
        assert (comm.rank, comm.num_ranks) == (0, 1)
        buf = torch.arange(12, dtype=torch.int32, device=dev).reshape(1, 6, 2)
        x = torch.rand(5, 3, device=dev)
        assert torch.equal(comm.all_to_all(buf), buf)
        assert torch.equal(comm.all_gather(x), x)
        assert torch.equal(comm.psum(x), x)
        cfg = dataclasses.replace(SMOKE_CONFIG, activity_impl="fused",
                                  connectivity_impl="fused",
                                  tree_impl="fused", apply_impl="fused")
        a = Simulator.from_config(cfg, comm=comm, device=dev)
        a.run(2)
        stats = a.stats()
        b = Simulator.from_config(cfg, device=dev)
        b.run(2)
        assert torch.equal(a.state.out_edges, b.state.out_edges)
        assert torch.equal(a.state.in_edges, b.state.in_edges)
        assert torch.equal(a.state.neurons.v, b.state.neurons.v)
        assert {k: v for k, v in stats.items() if "launches/" not in k} == \
            {k: v for k, v in b.stats().items() if "launches/" not in k}
    finally:
        tdist.destroy_process_group()


# ------------------------------------------------------------ comparisons
@pytest.mark.parametrize("n", [1000, 4099])
def test_activity_window_sparse_rates_equal_plain(dev, n):
    """K1 with the sparse exchange's operand at odd n: the (subs_cap,) rate
    buffer read through the (n, S) slot remap (slots -1 among them) of a
    rank of four, bit-equal to the plain window (integer weights)."""
    from repro_torch.core import spikes
    s, steps, rank = 8, 13, 1
    g = torch.Generator(device=dev).manual_seed(n)
    state = (torch.randn(n, generator=g, device=dev) * 5 - 60,
             torch.randn(n, generator=g, device=dev) * 2 - 13,
             torch.rand(n, generator=g, device=dev),
             torch.rand(n, generator=g, device=dev) * 2,
             torch.rand(n, generator=g, device=dev) * 2,
             torch.rand(n, generator=g, device=dev) < 0.2,
             torch.zeros(n, device=dev))
    edges = torch.randint(-1, 4 * n, (n, s), generator=g, device=dev,
                          dtype=torch.int32)
    # a registry smaller than the unique remote sources: overflowed slots
    subs, slots, ovf = spikes.build_subscriptions(edges, rank, n, n)
    buf = torch.rand(n, generator=g, device=dev) * 0.3
    w = torch.where(torch.arange(n, device=dev) < 4 * n // 5, 15.0, -15.0)
    kw = dict(seed=3, num_steps=steps, izh=(0.02, 0.2, -65.0, 8.0, 1e-3, 0.7),
              ca_consts=(1e-4, 2.4e-3), rate_slots=slots)
    before = af.launches.count
    a, a_spk = af.activity_window(state, edges, w, buf, 5.0, 1.0, 2, rank,
                                  **kw)
    b, b_spk = af.window_plain(state, edges, w, buf, 5.0, 1.0, 2, rank, **kw)
    assert af.launches.count == before + 1
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert torch.equal(a_spk, b_spk)
    assert float(ovf) > 0 and bool((slots >= 0).any())


def _global_tree(dev, cfg, num_ranks, rank, chunk=2):
    """The old algorithm's search inputs of rank ``rank``: the global tree
    of every rank's subtree and leaf data (as routing.formation_old
    downloads it, member gids global), and the rank's searchers with their
    phase-A branch cells."""
    from repro_torch.core import morton
    n = cfg.neurons_per_rank
    b = morton.branch_level(num_ranks)
    sts = [engine.init_state(cfg, r, num_ranks, device=dev)
           for r in range(num_ranks)]
    trees = [ctree.build_local_tree(st.positions, st.neurons.de_elements, r,
                                    cfg, num_ranks)
             for r, st in enumerate(sts)]
    counts = tuple(torch.cat([t.counts[k] for t in trees])
                   for k in range(len(trees[0].counts)))
    cents = tuple(torch.cat([t.centroids[k] for t in trees])
                  for k in range(len(trees[0].centroids)))
    members = torch.cat([torch.where(t.leaf_members >= 0,
                                     t.leaf_members + r * n, -1)
                         for r, t in enumerate(trees)])
    npos = torch.cat([st.positions for st in sts])
    vac = torch.cat([st.neurons.de_elements for st in sts])
    top = ctree.build_top_tree(counts[0], cents[0], num_ranks)
    pos = sts[rank].positions
    gids = rank * n + torch.arange(n, dtype=torch.int32, device=pos.device)
    start, valid = traverse.phase_a(top, pos, gids, cfg, num_ranks,
                                    chunk=chunk)
    stacked = traverse.stack_levels(counts, cents, b)
    kw = dict(seed=cfg.seed, sizes=stacked.sizes, theta=cfg.theta,
              sigma=cfg.sigma, frontier=cfg.frontier_cap,
              n_levels=cfg.local_levels + 1)
    args = (stacked.counts, stacked.centroids, members, npos, vac, pos,
            start, gids, valid, chunk, 0)
    return args, kw, tuple(c.shape[0] for c in counts)


def test_bh_traverse_on_the_global_tree_beyond_shared_memory(dev):
    """K2 as the old algorithm runs it at CONFIG, R=4, rank 3: the global
    tree of widths 8 ... 32,768 (37,448 packed nodes, 600 KB: most of it
    read through __ldg), member gids above 65,535, gid_base 0, 262,144
    neurons' positions: bit-equal to the plain search on every row."""
    cfg = dataclasses.replace(CONFIG, connectivity_impl="fused")
    args, kw, widths = _global_tree(dev, cfg, 4, 3)
    assert widths == (8, 64, 512, 4096, 32768)
    assert int(args[2].max()) >= 3 * cfg.neurons_per_rank
    got = bt.bh_traverse(*args, **kw, widths=widths)
    want = traverse.phase_b_core(*args, **kw)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert bool((want[0] >= 0).any()) and \
        bool((want[0] // cfg.neurons_per_rank != 3).any())


@pytest.mark.parametrize("field,value", [("connectivity_alg", "old"),
                                         ("rate_exchange", "sparse")])
def test_comparison_paths_equal_the_new_dense_path_on_the_card(dev, field,
                                                               value):
    """R=2 on the card, all five lowerings fused, through a lesion: the old
    connectivity algorithm and the sparse exchange form the same synapses
    as the new dense path (edge tables, every neuron field, formed and
    deleted counts bitwise equal), with no plain int64 Threefry on a CUDA
    tensor and health 0."""
    scn = library.lesion_rewiring()
    scn = dataclasses.replace(scn, events=tuple(
        dataclasses.replace(e, t=e.t // 5) for e in scn.events))
    base = dataclasses.replace(
        library.SMOKE_SCENARIO_CONFIG, activity_impl="fused",
        connectivity_impl="fused", tree_impl="fused", apply_impl="fused")
    out = []
    chash.plain_cuda_calls(reset=True)
    for cfg in (base, dataclasses.replace(base, **{field: value})):
        sim = Simulator.from_config(cfg, scenario=scn, device=dev,
                                    num_ranks=2)
        sim.run(4)
        assert sim.health()["health_flags"] == 0.0
        out.append((sim.state, sim.stats()))
    assert chash.plain_cuda_calls(reset=True) == 0
    (a, sa_), (b, sb) = out
    assert torch.equal(a.in_edges, b.in_edges)
    assert torch.equal(a.out_edges, b.out_edges)
    for f in a.neurons._fields:
        assert torch.equal(getattr(a.neurons, f), getattr(b.neurons, f)), f
    for k in ("synapses_formed", "synapses_deleted"):
        assert sa_[k] == sb[k], k
    assert sa_["synapses_deleted"] > 0


# --------------------------------------------- leaf sums (csrc/leaf_sums.cu)
@functools.lru_cache(maxsize=1)
def _surrogate_r4():
    """The R=4 surrogate at CONFIG's width (global Morton order: most rows
    of ranks 1-3 lie outside their block and are clamped into one leaf)."""
    from repro_torch.workloads import datasets as wds
    n = CONFIG.neurons_per_rank
    return wds.generate_hemibrain_surrogate(
        4 * n, n, max_degree=CONFIG.max_synapses,
        fraction_excitatory=CONFIG.fraction_excitatory)


def _leaf_case(dev, case):
    """(positions, weights, rank, num_ranks) of one tree build."""
    g = torch.Generator(device=dev).manual_seed(17)
    if case.startswith("surrogate_rank"):
        r, n = int(case[-1]), CONFIG.neurons_per_rank
        pos = torch.from_numpy(
            _surrogate_r4().positions[r * n:(r + 1) * n]).to(dev)
        rank, ranks = r, 4
    elif case == "one_leaf":     # rank 2 of 4's rows all in rank 0's block
        pos = torch.rand(65_536, 3, generator=g, device=dev) * 0.5
        rank, ranks = 2, 4
    else:
        pos = torch.rand(int(case), 3, generator=g, device=dev)
        rank, ranks = 0, 1
    w = torch.rand(pos.shape[0], generator=g, device=dev) * 3.0
    w = torch.where(torch.rand(pos.shape[0], generator=g, device=dev) < 0.2,
                    0.0, w)
    return pos, w, rank, ranks


def _leaf_inputs(dev, case):
    pos, w, rank, ranks = _leaf_case(dev, case)
    leaf_level, n_leaf, base = ctree._tree_geometry(rank, CONFIG, ranks)
    rel, slot = rs.morton_sort_plain(
        pos, base * 8 ** CONFIG.local_levels, leaf_level=leaf_level,
        n_leaf=n_leaf)
    return pos, w, rel, slot, n_leaf, rank, ranks


_LEAF_CASES = ["1", "3", "4099", "65537", "one_leaf", "surrogate_rank1",
               "surrogate_rank2"]


@pytest.mark.parametrize("case,members_cap",
                         [(c, 4) for c in _LEAF_CASES]
                         + [("65537", 1), ("one_leaf", 64), ("4099", 0)])
def test_leaf_sums_equal_plain(dev, case, members_cap):
    """The assembly kernel against the plain ``assemble_plain`` (the leaf
    sums of a dense table read column by column, ``_sum8``, the table
    scatter): every level's counts and centroids and the membership table
    bit-equal at odd sizes, with every row in one leaf, and at ranks 1 and
    2 of the R=4 CONFIG surrogate (rank 2: all 65,536 rows clamped into one
    leaf, summed by a whole block; the plain version's tables take 8.5 GB
    there), with members_cap overflowing (1), above every count (64) and
    0; one device launch a call; a second call bitwise equal."""
    from repro_torch.kernels import leaf_sums as ls
    pos, w, rel, slot, n_leaf, _, _ = _leaf_inputs(dev, case)
    levels = CONFIG.local_levels
    before = ls.launches.count
    ls.device_launches(reset=True)
    got = ls.assemble(pos, w, rel, slot, n_leaf, levels, members_cap)
    again = ls.assemble(pos, w, rel, slot, n_leaf, levels, members_cap)
    torch.cuda.synchronize()
    assert ls.launches.count == before + 2
    assert ls.device_launches(reset=True) == 2
    want = ctree.assemble_plain(pos, w, rel, slot, n_leaf, levels,
                                members_cap)
    for g, a, b in zip(got[:2], again[:2], want[:2]):
        assert len(g) == len(b) == levels + 1
        for x, y, z in zip(g, a, b):
            assert x.shape == z.shape
            assert torch.equal(x, z) and torch.equal(x, y)
    assert got[2].shape == (n_leaf, members_cap)
    assert torch.equal(got[2], want[2]) and torch.equal(got[2], again[2])
    if case in ("one_leaf", "surrogate_rank2"):
        assert int(slot.max()) == pos.shape[0] - 1
    del want
    torch.cuda.empty_cache()


@pytest.mark.parametrize("rank", [1, 2, 3])
def test_morton_sort_on_the_surrogate_ranks_equals_plain(dev, rank):
    """K3 on the clamped layout of the R=4 CONFIG surrogate: slots up to
    65,535 in one leaf, bit-equal to the plain version."""
    pos, _, rank, ranks = _leaf_case(dev, f"surrogate_rank{rank}")
    leaf_level, n_leaf, base = ctree._tree_geometry(rank, CONFIG, ranks)
    kw = dict(leaf_level=leaf_level, n_leaf=n_leaf)
    leaf_base = base * 8 ** CONFIG.local_levels
    got = rs.morton_sort(pos, leaf_base, **kw)
    want = rs.morton_sort_plain(pos, leaf_base, **kw)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("case", ["surrogate_rank2", "65537"])
def test_tree_build_does_not_wait_for_the_card(dev, case):
    """``_assemble_tree`` (and K3 before it) under the sync debug mode: the
    assembly reads no width on the host and is one launch of its kernel
    (one device launch); no plain leaf sum runs on the card; the tree
    equals the reference lowering's and the plain assembly's."""
    from repro_torch.kernels import leaf_sums as ls
    pos, w, rank, ranks = _leaf_case(dev, case)
    cfg = dataclasses.replace(CONFIG, tree_impl="fused")
    _build.library()
    ctree.build_tree(cfg, pos, w, rank, ranks)      # warm the caches
    torch.cuda.synchronize()
    ctree.plain_cuda_calls(reset=True)
    ls.device_launches(reset=True)
    before = ls.launches.count
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = ctree.build_tree(cfg, pos, w, rank, ranks)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert ls.launches.count == before + 1
    assert ls.device_launches(reset=True) == 1
    assert ctree.plain_cuda_calls(reset=True) == 0
    want = ctree.build_local_tree(pos, w, rank, CONFIG, ranks)
    for a, b in zip(got.counts + got.centroids, want.counts + want.centroids):
        assert torch.equal(a, b)
    assert torch.equal(got.leaf_members, want.leaf_members)
    _, n_leaf, base = ctree._tree_geometry(rank, CONFIG, ranks)
    rel, slot = rs.morton_sort_plain(
        pos, base * 8 ** CONFIG.local_levels,
        leaf_level=ctree._tree_geometry(rank, CONFIG, ranks)[0],
        n_leaf=n_leaf)
    plain = ctree.assemble_plain(pos, w, rel, slot, n_leaf,
                                 CONFIG.local_levels, 4)
    for a, b in zip(got.counts + got.centroids, plain[0] + plain[1]):
        assert torch.equal(a, b)
    assert torch.equal(got.leaf_members, plain[2])
    del plain
    torch.cuda.empty_cache()


# ------------------------------------------- K4's keyed accept, empty sides
def _k4_case(dev, n=4099, s=32, qm=0, qr=3 * 4099, masked=True, seed=21):
    """A compacted (n, s) table, qm messages that hit live slots (or None)
    and qr requests, a fifth of them to three crowded rows."""
    g = torch.Generator(device=dev).manual_seed(seed)
    i32 = torch.int32
    edges = torch.randint(0, 4 * n, (n, s), generator=g, device=dev,
                          dtype=i32)
    edges = compact(torch.where(torch.rand(n, s, generator=g, device=dev)
                                < 0.5, -1, edges))
    msgs = (None,) * 3
    if qm:
        live = torch.nonzero(edges >= 0)
        pick = live[torch.randint(0, live.shape[0], (qm,), generator=g,
                                  device=dev)]
        msgs = (pick[:, 0].to(i32), edges[pick[:, 0], pick[:, 1]],
                torch.rand(qm, generator=g, device=dev) < 0.9)
    tgt = torch.randint(0, n, (qr,), generator=g, device=dev, dtype=i32)
    tgt[: qr // 5] = tgt[: qr // 5] % 3
    src = torch.randint(0, 4 * n, (qr,), generator=g, device=dev, dtype=i32)
    valid = torch.rand(qr, generator=g, device=dev) < 0.7 if masked else \
        torch.ones(qr, dtype=torch.bool, device=dev)
    vac = torch.rand(n, generator=g, device=dev) * 8
    return edges, msgs, (tgt, src, valid), vac


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("with_messages", [False, True])
def test_synapse_apply_keyed_equals_priorities_and_plain(dev, masked,
                                                         with_messages):
    """K4's keyed mode (the priorities drawn in its count pass from the key
    words) == K4 fed ``edge_priority``'s priorities == the plain version,
    bitwise, with every request valid or a mask, and with no message side
    (qm = 0, null pointers) or messages too."""
    edges, msgs, req, vac = _k4_case(dev, qm=2000 if with_messages else 0,
                                     masked=masked)
    words = prng.split_words(prng.fold_in_words(prng.key_words(4), 11), 3)[2]
    keyed = sa.synapse_apply(edges, *msgs, *req, None, vac, key=words)
    prio = kr.edge_priority(words, req[1], req[0], req[2])
    fed = sa.synapse_apply(edges, *msgs, *req, prio, vac)
    plain = sa.synapse_apply_plain(edges, *msgs, *req, None, vac, key=words)
    for a, b, c in zip(keyed, fed, plain):
        assert torch.equal(a, b) and torch.equal(a, c)
    assert keyed[1].any() and not keyed[1][req[2]].all()


def test_synapse_apply_without_requests_equals_plain(dev):
    """K4 with no request side (qr = 0, null pointers, no vacancies): the
    drain alone, bit-equal to remove + compact; the accept mask empty."""
    edges, msgs, _, _ = _k4_case(dev, qm=6000, qr=8)
    got = sa.synapse_apply(edges, *msgs, None, None, None, None, None)
    want = sa.synapse_apply_plain(edges, *msgs, None, None, None, None, None)
    assert torch.equal(got[0], want[0]) and got[1].shape == (0,)
    assert not torch.equal(got[0], edges)


def test_fused_apply_draws_no_priorities_and_fills_nothing(dev):
    """The fused apply's accept and drain under the sync debug mode: no
    host read, no ``edge_priority`` launch, no constant fill of a
    placeholder operand (``_build.FillCounter``), and the results equal
    the reference lowering's."""
    from repro_torch.sim import registry
    fused = registry.resolve("apply", "fused")
    ref = registry.resolve("apply", "reference")
    edges, msgs, req, vac = _k4_case(dev, qm=3000)
    words = prng.split_words(prng.fold_in_words(prng.key_words(8), 2), 3)[2]
    _build.library()
    fused.accept(*req, vac, edges, words)             # warm the caches
    torch.cuda.synchronize()
    before = (kr.priority_launches.count, sa.apply_launches.count)
    torch.cuda.set_sync_debug_mode("error")
    try:
        with _build.FillCounter() as fills:
            acc, new_in = fused.accept(*req, vac, edges, words)
            drained = fused.deletion(edges, *msgs)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert fills.calls == []
    assert (kr.priority_launches.count, sa.apply_launches.count) == \
        (before[0], before[1] + 2)
    want_acc, want_in = ref.accept(*req, vac, edges,
                                   prng.key_tensor(words, dev))
    assert torch.equal(acc, want_acc) and torch.equal(new_in, want_in)
    assert torch.equal(drained, ref.deletion(edges, *msgs))


# ------------------------------------------------------------ runtime
def _all_fused(cfg):
    return dataclasses.replace(cfg, activity_impl="fused",
                               connectivity_impl="fused", tree_impl="fused",
                               apply_impl="fused")


def _states_equal(a, b):
    from repro_torch.checkpoint import manager
    la, lb = manager._flatten(a), manager._flatten(b)
    assert [k for k, _ in la] == [k for k, _ in lb]
    for (k, x), (_, y) in zip(la, lb):
        if isinstance(x, torch.Tensor):
            assert x.device == y.device and torch.equal(x, y), k
        else:
            assert x == y, k


@pytest.mark.parametrize("num_ranks", [1, 4])
def test_save_restore_on_the_card_bit_identical(dev, tmp_path, num_ranks):
    """A checkpoint saved from the card and restored onto it: two more
    chunks bitwise equal to the writer's two more, every leaf on the card."""
    cfg = _all_fused(SMOKE_CONFIG)
    a = Simulator.from_config(cfg, num_ranks=num_ranks, device=dev)
    a.run(2)
    assert a.save(str(tmp_path)) == 2
    a.run(2)
    b = Simulator.from_config(cfg, num_ranks=num_ranks, device=dev)
    assert b.restore(str(tmp_path)) == 2
    assert all(x.is_cuda for s in b.rank_states for x in s.neurons)
    b.run(2)
    _states_equal(a.state, b.state)


def test_probe_health_leaves_the_gauges_on_the_card(dev):
    """probe_health on a poisoned state flags it and leaves the gauges (so
    health() and the next checkpoint) as the last chunk wrote them."""
    from repro_torch.telemetry import metrics as tm
    sim = Simulator.from_config(_all_fused(SMOKE_CONFIG), num_ranks=2,
                                device=dev)
    sim.run(2)
    assert sim.probe_health() == 0
    st = sim.state
    v = st.neurons.v.clone()
    v[3] = float("nan")
    sim.state = st._replace(neurons=st.neurons._replace(v=v))
    gauges = [{k: x.clone() for k, x in s.stats.gauges.items()}
              for s in sim.rank_states]
    before = sim.health()
    assert sim.probe_health() == tm.HEALTH_NONFINITE
    assert sim.health() == before
    for g, s in zip(gauges, sim.rank_states):
        for k, x in s.stats.gauges.items():
            assert x.is_cuda and torch.equal(x, g[k]), k


def test_runner_kill_and_resume_on_the_card(dev, tmp_path):
    """The runner preempted at chunk 2 and a fresh one resuming there
    finish bitwise equal to an uninterrupted run, every kernel of the path
    launched under the runner."""
    from repro_torch.runtime import chaos
    from repro_torch.runtime.sim_runner import (SimRunnerConfig,
                                                SimulationRunner)
    cfg = _all_fused(SMOKE_CONFIG)
    ref = Simulator.from_config(cfg, device=dev)
    ref.run(4)
    ck = str(tmp_path / "ck")
    _build.reset_launch_counts()
    r = SimulationRunner(SimRunnerConfig(ck, ckpt_every=1), cfg=cfg,
                         device=dev)
    r.chaos_hooks.append(chaos.preempt_after(2))
    assert r.run(4) == "preempted"
    r2 = SimulationRunner(SimRunnerConfig(ck, ckpt_every=1), cfg=cfg,
                          device=dev)
    assert r2.sim.chunk == 2 and r2.sim.lifecycle["restarts"] == 1
    assert r2.run(2) == "done"
    counts = _build.launch_counts()
    for k in ("activity_window", "bh_traverse", "morton_sort",
              "synapse_apply", "route_build", "tree_assembly"):
        assert counts[k] > 0, k
    assert counts["activity_window"] == 4
    _states_equal(ref.state, r2.sim.state)


# ------------------------------------------------------------ service
def test_service_lanes_fused_on_the_card(dev):
    """A 2-slot service at SMOKE_CONFIG with all five fused lowerings: three
    tenants, slot 1 NaN-poisoned after its first chunk and rolled back;
    every tenant bitwise its solo fused run, every kernel of the chunk
    launched once (K4 three times, K5 and the retraction twice) a
    lane-chunk, replays included, and K0 three times an admission."""
    from repro_torch.runtime import chaos
    from repro_torch.service import (RequestStatus, ServiceConfig,
                                     SimRequest, SimulationService)
    cfg = _all_fused(SMOKE_CONFIG)
    solo = {}
    for s in (100, 101, 102):
        sim = Simulator.from_config(dataclasses.replace(cfg, seed=s),
                                    device=dev)
        sim.run(3)
        solo[s] = sim.state
    _build.reset_launch_counts()
    svc = SimulationService(cfg, ServiceConfig(num_slots=2), device=dev)
    svc.chaos_hooks.append(chaos.poison_slot_nan(1, after_chunk=1))
    hs = [svc.submit(SimRequest(seed=s, chunks=3)) for s in solo]
    svc.run_until_idle()
    counts = _build.launch_counts()
    stats = svc.stats()
    assert stats["quarantines"] == 1 and stats["slot_rollbacks"] == 1
    assert hs[1].result.retries == 1
    for h in hs:
        assert h.result.status is RequestStatus.DONE
        assert all(x.is_cuda for x in h.result.final_state.neurons)
        _states_equal(h.result.final_state, solo[h.request.seed])
    lane_chunks = svc.batch.lane_chunks
    assert lane_chunks == 9 + 1          # slot 1 replays its first chunk
    want = {"activity_window": 1, "bh_traverse": 1, "morton_sort": 1,
            "tree_assembly": 1, "synapse_apply": 3, "route_build": 2,
            "retract": 2}
    for k, per in want.items():
        assert counts[k] == per * lane_chunks, k
    assert counts["edge_priority"] == 0
    assert counts["threefry_words"] == 3 * stats["requests_admitted"]
    assert not svc.batch.health_flags(svc.state).any()
    assert not svc.batch.probe(svc.state).any()


def test_serve_driver_launches_the_kernels(dev, capsys):
    """``repro_torch.launch.serve --smoke`` on its default device, the
    card: its three tenants DONE, and the kernels of three admissions and
    nine lane-chunks launched (two slots, three tenants of three chunks,
    nothing replayed)."""
    from repro_torch.launch import serve
    _build.reset_launch_counts()
    assert serve.main(["--smoke"]) == 0
    counts = _build.launch_counts()
    assert capsys.readouterr().out.splitlines()[-1] == "3/3 tenants DONE"
    want = {"activity_window": 9, "bh_traverse": 9, "morton_sort": 9,
            "tree_assembly": 9, "synapse_apply": 27, "route_build": 18,
            "retract": 18, "threefry_words": 9, "edge_priority": 0}
    assert {k: counts[k] for k in want} == want


# ---------------------------------------------------------------- the LM
def _lm_f32(tree):
    if isinstance(tree, dict):
        return {k: _lm_f32(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_lm_f32(v) for v in tree]
    return tree.float()


@pytest.mark.parametrize("b,hq,hkv,d,s,window", [
    (2, 28, 4, 128, 300, 0),          # qwen2-7b's heads, full causal
    (1, 10, 1, 256, 2100, 2048),      # recurrentgemma-2b's, past the window
])
def test_lm_chunked_attention_runs_k9_on_a_prescaled_q(dev, b, hq, hkv, d,
                                                       s, window):
    """On the card the model's prefill attention is one K9 launch (its
    wgmma kernel at these head dims) on q pre-scaled as JAX scales it,
    with ``scale=1.0``: within ``bf16_error_bound`` of K9's plain version
    on the same inputs, as the reference lowering (the plain chunked
    online softmax) is; K9 takes no softcap and no explicit positions."""
    from repro_torch.models import attention as attn
    g = torch.Generator(device=dev).manual_seed(s)
    q = torch.randn((b, hq, s, d), generator=g, device=dev).bfloat16()
    k = torch.randn((b, hkv, s, d), generator=g, device=dev).bfloat16()
    v = torch.randn((b, hkv, s, d), generator=g, device=dev).bfloat16()
    fa.device_launches(reset=True)
    got = attn.chunked_attention(q, k, v, causal=True, window=window)
    assert fa.device_launches(reset=True) == {
        "wgmma_bf16": 1, "mma_sync_bf16": 0, "ffma_f32": 0}
    ref = attn.chunked_attention(q, k, v, causal=True, window=window,
                                 impl="reference")
    assert not any(fa.device_launches(reset=True).values())
    pre = attn.prescale(q)
    plain = fa.flash_attention_plain(pre, k, v, causal=True, window=window,
                                     scale=1.0)
    lim = fa.bf16_error_bound(plain, pre, k, v, causal=True, window=window,
                              scale=1.0)
    assert bool(((got.float() - plain.float()).abs() <= lim).all())
    assert bool(((ref.float() - plain.float()).abs() <= lim).all())
    with pytest.raises(NotImplementedError, match="softcap"):
        attn.chunked_attention(q, k, v, softcap=30.0)
    with pytest.raises(NotImplementedError, match="positions"):
        attn.chunked_attention(q, k, v, q_positions=torch.arange(
            s, device=dev))


@pytest.mark.parametrize("arch,layers,s", [("qwen2-7b", 1, 300),
                                           ("recurrentgemma-2b", 3, 2100)])
def test_lm_full_width_layers_fused_against_reference(dev, arch, layers, s):
    """The full config cut to its first layers (qwen2-7b: one attention
    layer; recurrentgemma-2b: rglru, rglru, attn, the prompt past the
    2,048 window), bf16: prefill and one decode step on the fused lowering
    (K9) against the reference lowering with the same params; logits within
    twice the reference's error against its f32 evaluation (the rule
    ``chip_smoke.py`` holds the whole models to)."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve_lm
    from repro_torch.models import build_model
    cfg = get_config(arch).replace(num_layers=layers)
    api = build_model(cfg)
    ref = build_model(cfg.replace(attention_impl="reference"))
    params = api.init(0, device=dev)
    batch = serve_lm.make_batch(cfg, 2, s, dev)
    _build.reset_launch_counts()
    f_logits, f_state = api.prefill(params, batch, pad_cache_to=s + 2)
    assert _build.launch_counts()["flash_attention"] == 1
    r_logits, r_state = ref.prefill(params, batch, pad_cache_to=s + 2)
    assert _build.launch_counts()["flash_attention"] == 1
    l32, _ = build_model(cfg.replace(
        dtype="float32", attention_impl="reference")).prefill(
        _lm_f32(params), batch, pad_cache_to=s + 2)
    tol = 2.0 * float((r_logits.float() - l32).abs().max())
    assert float((f_logits.float() - r_logits.float()).abs().max()) <= tol
    tok = torch.argmax(r_logits, -1).to(torch.int32)
    f_next, _ = api.decode_step(params, f_state, tok)
    r_next, _ = ref.decode_step(params, r_state, tok)
    assert _build.launch_counts()["flash_attention"] == 1
    assert float((f_next.float() - r_next.float()).abs().max()) <= tol


@pytest.mark.parametrize("arch,kw", [("qwen2-7b", {"scan_layers": True}),
                                     ("recurrentgemma-2b", {})])
def test_lm_decode_step_without_host_wait(dev, arch, kw):
    """A decode step (stacked caches; the RG-LRU states and a ring past its
    window) runs under ``set_sync_debug_mode("error")``: ``pos`` stays on
    the device, the cache write and the masks read it there. ``init``
    lands on the card by default."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import serve_lm
    from repro_torch.models import build_model
    cfg = get_smoke_config(arch).replace(**kw)
    api = build_model(cfg)
    params = api.init(0)
    assert params["embed"]["table"].is_cuda
    batch = serve_lm.make_batch(cfg, 2, 20, dev)
    logits, state = api.prefill(params, batch, pad_cache_to=24)
    tok = torch.argmax(logits, -1).to(torch.int32)
    logits, state = api.decode_step(params, state, tok)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(2):
            logits, state = api.decode_step(params, state, tok)
            tok = torch.argmax(logits, -1).to(torch.int32)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert int(state["pos"]) == 23


def test_lm_serve_driver_on_the_card(dev, capsys):
    """``repro_torch.launch.serve_lm`` on its default device: qwen3-14b
    and recurrentgemma-2b served (K9 on their 2 + 1 prefill attention
    layers), xlstm-125m and whisper-base named as later slices."""
    from repro_torch.launch import serve_lm
    _build.reset_launch_counts()
    assert serve_lm.main([]) == 0
    assert _build.launch_counts()["flash_attention"] == 3
    lines = capsys.readouterr().out.splitlines()
    assert "4x24+12" in lines[0] and "4x24+12" in lines[1]
    assert "not ported yet" in lines[2] and "not ported yet" in lines[3]
