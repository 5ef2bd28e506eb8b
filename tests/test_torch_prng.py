"""repro_torch.prng against jax.random (threefry2x32, partitionable): keys,
fold_in, split, random bits, uniform, randint and the synapse priorities
are bit-equal."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.connectome.synapses import edge_priority as jax_edge_priority
from repro_torch import prng
from repro_torch.connectome.synapses import edge_priority

SEEDS = [0, 2, 12345]


def _kd(k):
    return np.asarray(jax.random.key_data(k)).astype(np.int64)


def test_reference_runs_partitionable_threefry():
    assert jax.config.jax_threefry_partitionable
    assert str(jax.random.key_impl(jax.random.key(0))) == "threefry2x32"


@pytest.mark.parametrize("seed", SEEDS)
def test_key_fold_in_split(seed):
    k, t = jax.random.key(seed), prng.key(seed)
    np.testing.assert_array_equal(_kd(k), t.numpy())
    for d in (0, 1, 7, 2 ** 31 - 1):
        np.testing.assert_array_equal(_kd(jax.random.fold_in(k, d)),
                                      prng.fold_in(t, d).numpy())
    for num in (2, 3, 5):
        np.testing.assert_array_equal(_kd(jax.random.split(k, num)),
                                      prng.split(t, num).numpy())


@pytest.mark.parametrize("seed", SEEDS)
def test_random_bits(seed):
    k = jax.random.key(seed)
    want = np.asarray(jax.random.bits(k, (37, 3), jnp.uint32))
    got = prng.random_bits(prng.key(seed), (37, 3))
    np.testing.assert_array_equal(want.astype(np.int64), got.numpy())


@pytest.mark.parametrize("lo,hi", [(0.0, 1.0), (1.1, 1.5), (-2.0, 3.0)])
@pytest.mark.parametrize("seed", SEEDS)
def test_uniform(seed, lo, hi):
    k = jax.random.fold_in(jax.random.key(seed), 4)
    t = prng.fold_in(prng.key(seed), 4)
    want = np.asarray(jax.random.uniform(k, (257, 2), minval=lo, maxval=hi))
    got = prng.uniform(t, (257, 2), minval=lo, maxval=hi)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(want, got.numpy())


@pytest.mark.parametrize("lo,hi", [(0, 1), (0, 8), (3, 1000), (0, 2 ** 31 - 1),
                                   (5, 5)])
def test_randint(lo, hi):
    k, t = jax.random.key(9), prng.key(9)
    want = np.asarray(jax.random.randint(k, (513,), lo, hi))
    got = prng.randint(t, (513,), lo, hi)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(want, got.numpy())


@pytest.mark.parametrize("seed", SEEDS)
def test_edge_priority(seed):
    rng = np.random.default_rng(seed)
    a = rng.integers(-3, 1 << 20, 2048).astype(np.int32)
    b = rng.integers(0, 1 << 20, 2048).astype(np.int32)
    k = jax.random.fold_in(jax.random.key(seed + 2), 3)
    t = prng.fold_in(prng.key(seed + 2), 3)
    want = np.asarray(jax_edge_priority(k, jnp.asarray(a), jnp.asarray(b)))
    got = edge_priority(t, torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_array_equal(want, got.numpy())
