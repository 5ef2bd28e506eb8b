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
from repro_torch.core import engine
from repro_torch.kernels import activity_fused as af
from repro_torch.kernels import bh_traverse as bt
from repro_torch.kernels import hash as chash
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
