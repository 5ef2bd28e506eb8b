"""Retraction and the synapse priorities of the fused apply lowering
(``kernels/retract.py``) on CPU tensors against the JAX package, and the
host-int key derivation (``prng.key_words`` / ``fold_in_words`` /
``split_words``) against ``prng``'s key tensors and ``jax.random``.

On CPU tensors the fused entries run the plain versions, so these hold the
keys the chunk passes them (two u32 words by value) and the plain arithmetic
against the reference: everything is bit-equal. The kernels themselves are
held against the plain versions on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.connectome import synapses as jsyn
from repro_torch import prng
from repro_torch.connectome import synapses as tsyn
from repro_torch.kernels import hash as chash
from repro_torch.kernels import retract as kr
from repro_torch.sim import registry as tregistry

SEEDS = [0, 7, 12345]
CHUNKS = [0, 1, 11, 2 ** 31 - 2, 2 ** 31 - 1]


def _kd(k):
    return tuple(int(v) for v in np.asarray(jax.random.key_data(k)))


def _rows(rng, n, s, case):
    """An (n, s) edge table and per-row deletion counts for one case."""
    gid_hi = 4 * n
    if case == "empty":
        edges = np.full((n, s), -1, np.int32)
    elif case == "full":
        edges = rng.integers(0, gid_hi, (n, s)).astype(np.int32)
    elif case == "duplicates":      # a row holds few partners, repeated
        edges = (rng.integers(0, 3, (n, s))
                 + np.arange(n)[:, None] * 7).astype(np.int32)
        edges[rng.random((n, s)) < 0.2] = -1
    else:                           # "mixed": holes, some rows empty
        edges = rng.integers(0, gid_hi, (n, s)).astype(np.int32)
        edges[rng.random((n, s)) < 0.4] = -1
        edges[::5] = -1
    count = (edges >= 0).sum(1)
    n_del = rng.integers(0, s + 1, n)
    if case == "lesion":            # n_delete at or above the count
        edges = rng.integers(0, gid_hi, (n, s)).astype(np.int32)
        edges[rng.random((n, s)) < 0.3] = -1
        count = (edges >= 0).sum(1)
        n_del = count + rng.integers(0, 3, n)
    elif case == "full":
        n_del[::3] = s              # every slot
        n_del[1::3] = 0
    return edges, n_del.astype(np.int32)


@pytest.mark.parametrize("case", ["empty", "full", "lesion", "duplicates",
                                  "mixed"])
@pytest.mark.parametrize("s", [1, 8, 32])
def test_fused_retract_equals_jax(s, case):
    rng = np.random.default_rng(s * 31 + len(case))
    n = 96
    edges, n_del = _rows(rng, n, s, case)
    gids = (np.arange(n) + 1000).astype(np.int32)
    seed, chunk = 3, 5
    words = prng.split_words(prng.fold_in_words(prng.key_words(seed),
                                                chunk), 3)[0]
    jkey = jax.random.split(jax.random.fold_in(jax.random.key(seed), chunk),
                            3)[0]
    we, wk = jax.jit(jsyn.retract_synapses)(jkey, jnp.asarray(edges),
                                            jnp.asarray(n_del),
                                            jnp.asarray(gids))
    fused = tregistry.resolve("apply", "fused")
    ge, gk = fused.retract(words, torch.from_numpy(edges),
                           torch.from_numpy(n_del), torch.from_numpy(gids))
    np.testing.assert_array_equal(np.asarray(we), ge.numpy())
    np.testing.assert_array_equal(np.asarray(wk), gk.numpy())
    assert gk.dtype == torch.bool
    reference = tregistry.resolve("apply", "reference")
    re, rk = reference.retract(words, torch.from_numpy(edges),
                               torch.from_numpy(n_del),
                               torch.from_numpy(gids))
    assert torch.equal(re, ge) and torch.equal(rk, gk)
    count = (edges >= 0).sum(1)
    if case == "lesion":            # every occupied slot dies, none drawn
        np.testing.assert_array_equal(gk.numpy(), edges >= 0)
    if case in ("full", "duplicates", "mixed"):
        killed = gk.numpy().sum(1)
        np.testing.assert_array_equal(killed, np.minimum(n_del, count))


@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("seed", SEEDS)
def test_host_key_words_equal_prng_and_jax(seed, chunk):
    words = prng.fold_in_words(prng.key_words(seed + 2), chunk)
    tensor = prng.fold_in(prng.key(seed + 2), chunk)
    jkey = jax.random.fold_in(jax.random.key(seed + 2), chunk)
    assert words == tuple(tensor.tolist()) == _kd(jkey)
    split = prng.split_words(words, 3)
    np.testing.assert_array_equal(np.asarray(split),
                                  prng.split(tensor, 3).numpy())
    assert split == tuple(_kd(k) for k in jax.random.split(jkey, 3))
    assert prng.as_words(tensor) == words
    assert torch.equal(prng.key_tensor(words), tensor)


@pytest.mark.parametrize("seed", SEEDS)
def test_threefry_on_ints_equals_plain(seed):
    rng = np.random.default_rng(seed)
    for k0, k1, c0, c1 in rng.integers(0, 2 ** 32, (64, 4), dtype=np.int64):
        want = chash.threefry2x32(int(k0), int(k1), int(c0), int(c1))
        assert chash.threefry2x32_int(int(k0), int(k1), int(c0),
                                      int(c1)) == tuple(int(w) for w in want)


@pytest.mark.parametrize("seed", SEEDS)
def test_accept_priorities_equal_jax_request_priority(seed):
    rng = np.random.default_rng(seed)
    q, n = 3000, 1 << 16
    tgt = rng.integers(0, n, q).astype(np.int32)
    src = rng.integers(0, n, q).astype(np.int32)
    valid = rng.random(q) < 0.6
    words = prng.split_words(prng.fold_in_words(prng.key_words(seed + 2),
                                                9), 3)[2]
    jkey = jax.random.split(jax.random.fold_in(jax.random.key(seed + 2), 9),
                            3)[2]
    want = np.asarray(jsyn.request_priority(jkey, jnp.asarray(tgt),
                                            jnp.asarray(src),
                                            jnp.asarray(valid)))
    got = kr.edge_priority(words, torch.from_numpy(src), torch.from_numpy(tgt),
                           torch.from_numpy(valid))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(want, got.numpy())
    pairs = kr.edge_priority(words, torch.from_numpy(src),
                             torch.from_numpy(tgt))
    np.testing.assert_array_equal(
        np.asarray(jsyn.edge_priority(jkey, jnp.asarray(src),
                                      jnp.asarray(tgt))), pairs.numpy())


@pytest.mark.parametrize("seed", [0, 1])
def test_fused_accept_with_key_words_equals_jax(seed):
    rng = np.random.default_rng(seed)
    n, s, q = 200, 8, 900
    in_edges = rng.integers(0, 4 * n, (n, s)).astype(np.int32)
    in_edges[rng.random((n, s)) < 0.5] = -1
    in_edges = np.asarray(jsyn.compact(jnp.asarray(in_edges)))
    tgt = rng.integers(0, n, q).astype(np.int32)
    src = rng.integers(0, 4 * n, q).astype(np.int32)
    valid = rng.random(q) < 0.8
    vac = (rng.random(n) * 6).astype(np.float32)
    words = prng.split_words(prng.fold_in_words(prng.key_words(seed), 4),
                             3)[2]
    jkey = jax.random.split(jax.random.fold_in(jax.random.key(seed), 4),
                            3)[2]
    wa, wn = jax.jit(jsyn.accept_requests)(
        jnp.asarray(tgt), jnp.asarray(src), jnp.asarray(valid),
        jnp.asarray(vac), jnp.asarray(in_edges), jkey)
    fused = tregistry.resolve("apply", "fused")
    ga, gn = fused.accept(*(torch.from_numpy(a) for a in (
        tgt, src, valid, vac, in_edges)), words)
    np.testing.assert_array_equal(np.asarray(wa), ga.numpy())
    np.testing.assert_array_equal(np.asarray(wn), gn.numpy())
    assert ga.sum() > 0
