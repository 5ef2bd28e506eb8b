"""Port's init_state, Morton codes and population tables against the JAX
package: integers bit-equal, positions within 1 ulp (they come out equal)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.msp_brain import SMOKE_CONFIG as J_SMOKE
from repro.core import engine as jengine
from repro.core import morton as jmorton
from repro.scenarios import populations as jpops
from repro_torch import convert, prng
from repro_torch.configs.msp_brain import SMOKE_CONFIG as T_SMOKE
from repro_torch.core import engine as tengine
from repro_torch.core import morton as tmorton
from repro_torch.scenarios import populations as tpops


@pytest.mark.parametrize("seed", [0, 3])
def test_init_state_matches_reference(seed):
    jcfg = dataclasses.replace(J_SMOKE, seed=seed)
    tcfg = dataclasses.replace(T_SMOKE, seed=seed)
    want = jax.device_get(jengine.init_state(jcfg, 0, 1))
    got = tengine.init_state(tcfg, 0, 1, device="cpu")
    pos_w, pos_g = np.asarray(want.positions), got.positions.numpy()
    assert pos_g.dtype == np.float32 and pos_g.shape == pos_w.shape
    ulps = np.abs(pos_w.view(np.int32).astype(np.int64)
                  - pos_g.view(np.int32))
    assert ulps.max() <= 1
    for f in ("v", "u", "calcium", "ax_elements", "de_elements", "spiked",
              "spike_count", "rate", "is_excitatory"):
        np.testing.assert_array_equal(np.asarray(getattr(want.neurons, f)),
                                      getattr(got.neurons, f).numpy(),
                                      err_msg=f)
    np.testing.assert_array_equal(np.asarray(want.in_edges),
                                  got.in_edges.numpy())
    np.testing.assert_array_equal(np.asarray(want.out_edges),
                                  got.out_edges.numpy())
    np.testing.assert_array_equal(np.asarray(want.rates_table),
                                  got.rates_table.numpy())
    assert got.chunk == int(want.chunk) == 0
    assert set(got.stats.counters) == set(want.stats.counters)


def test_state_round_trip_through_numpy():
    want = jax.device_get(jengine.init_state(J_SMOKE, 0, 1))
    st = convert.state_from_numpy(want, device="cpu")
    back = convert.state_to_numpy(st)
    np.testing.assert_array_equal(back["positions"],
                                  np.asarray(want.positions))
    np.testing.assert_array_equal(back["neurons"]["ax_elements"],
                                  np.asarray(want.neurons.ax_elements))
    for k, v in want.stats.counters.items():
        np.testing.assert_array_equal(back["stats"]["counters"][k],
                                      np.asarray(v))
    again = convert.state_from_numpy(
        type("S", (), {**{k: v for k, v in back.items()
                          if k not in ("neurons", "stats")},
                       "neurons": type("N", (), back["neurons"]),
                       "stats": type("M", (), back["stats"])}),
        device="cpu")
    assert torch.equal(again.in_edges, st.in_edges)


@pytest.mark.parametrize("ranks", [1, 2, 4, 8, 9, 64])
def test_rank_decomposition(ranks):
    assert tmorton.branch_level(ranks) == jmorton.branch_level(ranks)
    assert tmorton.cells_per_rank(ranks) == jmorton.cells_per_rank(ranks)


@pytest.mark.parametrize("level", [0, 1, 3, 5])
def test_morton_encode_and_centers(level):
    rng = np.random.default_rng(level)
    pos = rng.random((500, 3), dtype=np.float32)
    np.testing.assert_array_equal(
        np.asarray(jmorton.morton_encode(jnp.asarray(pos), level)),
        tmorton.morton_encode(torch.from_numpy(pos), level).numpy())
    cells = rng.integers(0, 8 ** level, 300).astype(np.int32)
    np.testing.assert_array_equal(
        np.asarray(jmorton.morton_cell_center(jnp.asarray(cells), level)),
        tmorton.morton_cell_center(torch.from_numpy(cells), level).numpy())


@pytest.mark.parametrize("base,ncells,level", [(0, 1, 0), (2, 2, 1), (6, 8, 2)])
def test_sample_positions_in_cells(base, ncells, level):
    want = np.asarray(jmorton.sample_positions_in_cells(
        jax.random.key(5), base, ncells, 200, level))
    got = tmorton.sample_positions_in_cells(prng.key(5), base, ncells, 200,
                                            level)
    np.testing.assert_array_equal(want, got.numpy())


def test_population_tables_match():
    specs_j = (jpops.population("rs", 0.5, "RS"),
               jpops.population("ch", 0.25, "CH", target_calcium=0.4),
               jpops.population("fs", 0.25, "FS", is_excitatory=False))
    specs_t = (tpops.population("rs", 0.5, "RS"),
               tpops.population("ch", 0.25, "CH", target_calcium=0.4),
               tpops.population("fs", 0.25, "FS", is_excitatory=False))
    for pops_j, pops_t in ((specs_j, specs_t),
                           (jpops.default_populations(J_SMOKE),
                            tpops.default_populations(T_SMOKE))):
        want = jpops.build_table(J_SMOKE, pops_j, 101)
        got = tpops.build_table(T_SMOKE, pops_t, 101)
        for f in want._fields:
            np.testing.assert_array_equal(np.asarray(getattr(want, f)),
                                          getattr(got, f).numpy(), err_msg=f)
