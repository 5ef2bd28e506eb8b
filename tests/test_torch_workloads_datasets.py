"""The port's connectome datasets (``repro_torch.workloads.datasets``, numpy
only) against the JAX package's: the surrogate generator bit-equal (the same
PCG64 stream), the edge tables and the measured subscription base
bit-equal, the on-disk format round-tripped by both, the same ValueErrors,
and the generator's invariants on the port's copy."""
import dataclasses

import numpy as np
import pytest

from repro.configs.msp_brain import SMOKE_CONFIG as JSMOKE
from repro.workloads import datasets as jwds
from repro_torch.configs.msp_brain import SMOKE_CONFIG
from repro_torch.scenarios.regions import Region
from repro_torch.workloads import datasets as twds

CFG = dataclasses.replace(SMOKE_CONFIG, requests_cap_factor=1000)
N = CFG.neurons_per_rank


def _args(**kw):
    args = dict(num_neurons=N, block=N, max_degree=CFG.max_synapses,
                fraction_excitatory=CFG.fraction_excitatory)
    args.update(kw)
    return args


def _assert_same(a, b):
    assert type(a).__name__ == type(b).__name__ == "ConnectomeDataset"
    for name, fa, fb in zip(a._fields, a, b):
        if isinstance(fa, np.ndarray):
            assert fa.dtype == fb.dtype, name
            np.testing.assert_array_equal(fa, fb, err_msg=name)
        else:
            assert fa == fb, name


@pytest.mark.parametrize("seed", [0, 1, 7])
@pytest.mark.parametrize("size", [(N, N), (4 * N, N)])
def test_generator_is_bit_equal_to_jax(seed, size):
    """The same arguments give the same dataset, field by field and dtype
    by dtype, as the JAX package's generator."""
    kw = _args(num_neurons=size[0], block=size[1], seed=seed,
               avg_degree=5.0)
    _assert_same(twds.generate_hemibrain_surrogate(**kw),
                 jwds.generate_hemibrain_surrogate(**kw))


@pytest.mark.parametrize("ranks", [1, 2, 4])
def test_edge_tables_and_remote_sources_are_bit_equal(ranks):
    ds = twds.generate_hemibrain_surrogate(**_args(num_neurons=ranks * N,
                                                   seed=3))
    for got, want in zip(twds.edge_tables(ds, CFG.max_synapses),
                         jwds.edge_tables(ds, CFG.max_synapses)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    assert twds.max_unique_remote_sources(ds, N) == \
        jwds.max_unique_remote_sources(ds, N)
    assert (twds.max_unique_remote_sources(ds, N) == 0) == (ranks == 1)


def test_save_load_round_trip_across_packages(tmp_path):
    """A file the port writes, JAX reads to the same dataset, and the other
    way round."""
    ds = twds.generate_hemibrain_surrogate(**_args(num_neurons=2 * N))
    a, b = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    twds.save(a, ds)
    jwds.save(b, ds)
    for path in (a, b):
        _assert_same(twds.load(path), ds)
        _assert_same(jwds.load(path), ds)


def test_load_rejects_future_format(tmp_path):
    ds = twds.generate_hemibrain_surrogate(**_args())
    path = str(tmp_path / "surrogate.npz")
    twds.save(path, ds)
    with np.load(path, allow_pickle=False) as z:
        fields = dict(z)
    fields["format_version"] = np.int64(twds.FORMAT_VERSION + 1)
    np.savez_compressed(path, **fields)
    assert twds.FORMAT == jwds.FORMAT
    for mod in (twds, jwds):
        with pytest.raises(ValueError, match="format_version"):
            mod.load(path)


def _message(fn, *args):
    with pytest.raises(ValueError) as err:
        fn(*args)
    return str(err.value)


def test_value_errors_are_jax_s():
    """Population layout, a degree over ``max_synapses`` and gid != row:
    the same ValueError messages as the JAX package's."""
    from repro.sim.api import Simulator as JSim
    from repro_torch.sim.api import Simulator as TSim
    jcfg = dataclasses.replace(JSMOKE, requests_cap_factor=1000)
    bad_layout = twds.generate_hemibrain_surrogate(
        **_args(fraction_excitatory=0.5))
    assert _message(twds.check_population_layout, bad_layout, CFG, None,
                    1) == _message(jwds.check_population_layout, bad_layout,
                                   jcfg, None, 1)
    assert "population table" in _message(
        TSim.from_connectome, CFG, bad_layout, None, 1, "cpu")
    ds = twds.generate_hemibrain_surrogate(**_args())
    msg = _message(twds.edge_tables, ds, CFG.max_synapses // 2)
    assert "max_synapses" in msg
    assert msg == _message(jwds.edge_tables, ds, CFG.max_synapses // 2)
    two = twds.generate_hemibrain_surrogate(**_args(num_neurons=2 * N))
    msg = _message(TSim.from_connectome, CFG, two, None, 1, "cpu")
    assert "gid == global row" in msg
    assert msg == _message(JSim.from_connectome, jcfg, two)
    broken = ds._replace(edges=ds.edges[:, ::-1].copy())
    assert _message(twds.validate, broken) == _message(jwds.validate, broken)


def test_generator_invariants():
    """The JAX package's generator invariants, on the port's copy."""
    ds = twds.generate_hemibrain_surrogate(
        **_args(num_neurons=8 * N, avg_degree=4.0, degree_sigma=1.0))
    out_deg, in_deg = ds.out_degrees(), ds.in_degrees()
    assert out_deg.max() <= CFG.max_synapses
    assert in_deg.max() <= CFG.max_synapses
    assert out_deg.max() >= 2 * np.median(out_deg)
    exc = ds.is_excitatory.reshape(-1, N)
    np.testing.assert_array_equal(exc, np.broadcast_to(exc[0], exc.shape))
    assert exc[0, :int(N * CFG.fraction_excitatory)].all()
    assert not exc[0, int(N * CFG.fraction_excitatory):].any()
    box = ds.region_boxes[ds.region_ids]
    assert (ds.positions >= box[:, 0]).all() and \
        (ds.positions < box[:, 1]).all()
    order = np.lexsort((ds.edges[:, 1], ds.edges[:, 0]))
    np.testing.assert_array_equal(order, np.arange(ds.num_edges))
    rsrc = ds.region_ids[ds.edges[:, 0]]
    rtgt = ds.region_ids[ds.edges[:, 1]]
    assert (rsrc == rtgt).mean() > 0.5


def test_regions_are_the_port_s():
    ds = twds.generate_hemibrain_surrogate(**_args())
    regions = ds.regions()
    assert all(isinstance(r, Region) for r in regions)
    want = jwds.generate_hemibrain_surrogate(**_args()).regions()
    assert [(r.name, r.lo, r.hi) for r in regions] == \
        [(r.name, r.lo, r.hi) for r in want]
