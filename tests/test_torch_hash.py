"""K0 plain version (repro_torch/kernels/hash.py) against the JAX package's
counter hash: Threefry words and uniforms bit-equal, normal and Gumbel
within 4 ulp at the scale max(|x|, 1) (XLA:CPU and torch differ in the last
bits of log/log1p/cos)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import hash as jh
from repro_torch.kernels import hash as th

DOMAINS = [jh.NOISE_DOMAIN, jh.SPIKE_DOMAIN, jh.BH_DOMAIN]


def _words(seed, size=4096):
    rng = np.random.default_rng(seed)
    c = rng.integers(0, 2 ** 32, size=size, dtype=np.uint64)
    e = rng.integers(0, 2 ** 32, size=size, dtype=np.uint64)
    return c.astype(np.uint32), e.astype(np.uint32)


def _both(fn_name, seed, domain, c, e):
    a = getattr(jh, fn_name)(seed, domain, jnp.asarray(c), jnp.asarray(e))
    b = getattr(th, fn_name)(seed, domain, torch.from_numpy(c.astype(np.int64)),
                             torch.from_numpy(e.astype(np.int64)))
    return a, b


def test_constants_match_reference():
    assert (th.NOISE_DOMAIN, th.SPIKE_DOMAIN, th.BH_DOMAIN) == tuple(DOMAINS)
    assert (th.BH_ROUNDS, th.BH_DRAWS) == (jh.BH_ROUNDS, jh.BH_DRAWS)


@pytest.mark.parametrize("key,ctr,want", [
    ((0, 0), (0, 0), (0x6B200159, 0x99BA4EFE)),
    ((0xFFFFFFFF,) * 2, (0xFFFFFFFF,) * 2, (0x1CB996FC, 0xBB002BE7)),
])
def test_random123_known_answers(key, ctr, want):
    x0, x1 = th.threefry2x32(*key, *ctr)
    assert (int(x0), int(x1)) == want


@pytest.mark.parametrize("domain", DOMAINS)
@pytest.mark.parametrize("seed", [0, 7, 2 ** 31 - 1])
def test_threefry_words_bit_equal(seed, domain):
    c, e = _words(seed)
    (a0, a1), (b0, b1) = _both("bits", seed, domain, c, e)
    np.testing.assert_array_equal(np.asarray(a0).astype(np.int64), b0.numpy())
    np.testing.assert_array_equal(np.asarray(a1).astype(np.int64), b1.numpy())


@pytest.mark.parametrize("domain", DOMAINS)
def test_uniform_bit_equal(domain):
    c, e = _words(11)
    a, b = _both("uniform", 3, domain, c, e)
    np.testing.assert_array_equal(np.asarray(a), b.numpy())
    assert b.dtype == torch.float32


def _scaled_ulps(a, b):
    a = np.asarray(a, np.float32)
    scale = np.spacing(np.maximum(np.abs(a), np.float32(1.0)))
    return np.abs(a.astype(np.float64) - b.numpy().astype(np.float64)) / scale


@pytest.mark.parametrize("fn_name", ["normal", "gumbel"])
@pytest.mark.parametrize("domain", DOMAINS)
def test_transcendentals_within_4_ulp(fn_name, domain):
    c, e = _words(5, size=1 << 15)
    a, b = _both(fn_name, 0, domain, c, e)
    assert np.isfinite(b.numpy()).all()
    assert _scaled_ulps(a, b).max() <= 4.0


def test_bh_ctr_matches_int32_wraparound():
    draws = np.arange(128, dtype=np.int32)
    for chunk in (0, 3, 524_287, 2 ** 20):
        for rnd in (0, 16, 63):
            want = np.asarray(jh.bh_ctr(chunk, rnd, jnp.asarray(draws)))
            got = th.bh_ctr(chunk, rnd, torch.from_numpy(draws))
            np.testing.assert_array_equal(
                want.astype(np.int64) & 0xFFFFFFFF, got.numpy())


def test_threefry_words_cpu_path_is_plain_version():
    c, e = _words(2, size=64)
    k0 = torch.full((64,), 5, dtype=torch.int64)
    k1 = torch.full((64,), th.SPIKE_DOMAIN, dtype=torch.int64)
    cc, ee = torch.from_numpy(c.astype(np.int64)), torch.from_numpy(
        e.astype(np.int64))
    before = th.launches.count
    got = th.threefry_words(k0, k1, cc, ee)
    want = th.threefry2x32(5, th.SPIKE_DOMAIN, cc, ee)
    assert th.launches.count == before       # no kernel on a CPU tensor
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w.numpy())
