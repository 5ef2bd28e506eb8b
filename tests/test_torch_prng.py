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


@pytest.mark.parametrize("lo,hi", [(0.0, 1.0), (1.1, 1.5), (-2.0, 3.0),
                                   (1e-30, 3.0), (1e6, 1e6 + 1.0),
                                   (-3e7, -3e7 + 0.25)])
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


# ------------------------------------------ keys as host words, the draws
@pytest.mark.parametrize("seed,rank", [(0, 0), (42, 0), (12345, 3)])
def test_init_state_keys_as_words(seed, rank):
    """``init_state``'s keys derived on the host as words equal the tensor
    derivation and jax.random's: the rank key, its split (positions,
    neurons) and the splits inside ``sample_positions_in_cells`` and
    ``init_neurons``."""
    k = prng.fold_in_words(prng.key_words(seed), rank)
    kp, kn = prng.split_words(k)
    t = prng.fold_in(prng.key(seed), rank)
    tp, tn = prng.split(t)
    j = jax.random.fold_in(jax.random.key(seed), rank)
    jp, jn = jax.random.split(j)
    for words, tensor, jkey in ((k, t, j), (kp, tp, jp), (kn, tn, jn)):
        assert words == tuple(tensor.tolist()) == tuple(_kd(jkey).tolist())
    for words, jkey in ((kp, jp), (kn, jn)):
        got = prng.split_words(words)
        assert [list(x) for x in got] == _kd(jax.random.split(jkey)).tolist()


def test_sample_positions_and_init_neurons_take_words_or_a_key_tensor():
    """Both take a key tensor (its device) or two words (``device``), give
    the same draws, and those are jax's."""
    from repro.configs.msp_brain import BrainConfig as JConfig
    from repro.core import morton as jmorton
    from repro.core.neuron import init_neurons as jinit_neurons
    from repro_torch.configs.msp_brain import BrainConfig as TConfig
    from repro_torch.core import morton
    from repro_torch.core.neuron import init_neurons
    words = prng.fold_in_words(prng.key_words(5), 1)
    tensor = prng.key_tensor(words)
    jkey = jax.random.fold_in(jax.random.key(5), 1)
    a = morton.sample_positions_in_cells(words, 2, 6, 301, 2, device="cpu")
    b = morton.sample_positions_in_cells(tensor, 2, 6, 301, 2)
    want = np.asarray(jmorton.sample_positions_in_cells(jkey, 2, 6, 301, 2))
    assert torch.equal(a, b)
    np.testing.assert_array_equal(want, a.numpy())
    na = init_neurons(words, TConfig(), 257, device="cpu")
    nb = init_neurons(tensor, TConfig(), 257)
    jn = jinit_neurons(jkey, JConfig(), 257)
    for x, y in zip(na, nb):
        assert torch.equal(x, y)
    np.testing.assert_array_equal(np.asarray(jn.ax_elements),
                                  na.ax_elements.numpy())
    np.testing.assert_array_equal(np.asarray(jn.de_elements),
                                  na.de_elements.numpy())


@pytest.mark.parametrize("fn,args", [
    ("fold_in", (7,)), ("split", (3,)), ("random_bits", ((5, 3),)),
    ("uniform", ((4, 3), -1.5, 2.0)), ("randint", ((9,), 3, 1000))])
def test_tensor_functions_take_words(fn, args):
    """Each tensor function gives the same result for a key of words (on
    ``device``) as for the key tensor, and equals its plain version."""
    words = prng.fold_in_words(prng.key_words(11), 2)
    tensor = prng.key_tensor(words)
    a = getattr(prng, fn)(words, *args, device="cpu")
    b = getattr(prng, fn)(tensor, *args)
    c = getattr(prng, fn + "_plain")(tensor, *args)
    assert torch.equal(a, b) and torch.equal(a, c)


@pytest.mark.parametrize("fn,args", [
    ("fold_in", (7,)), ("split", (3,)), ("random_bits", ((5, 3),)),
    ("uniform", ((4, 3),)), ("randint", ((9,), 3, 1000))])
def test_words_key_without_device_goes_to_the_card(monkeypatch, fn, args):
    """With a key of words, no tensor operand and no ``device``, a tensor
    function runs on the card (``device.resolve_device``): where none is
    visible it raises, never falling back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    words = prng.fold_in_words(prng.key_words(11), 2)
    with pytest.raises(RuntimeError, match="NVIDIA GPU"):
        getattr(prng, fn)(words, *args)


def _f32_rounded(q):
    """The float32 nearest the rational ``q``, ties to even."""
    from fractions import Fraction
    a = np.float32(float(q))
    cands = [a, np.nextafter(a, np.float32(np.inf)),
             np.nextafter(a, np.float32(-np.inf))]
    return min(cands, key=lambda c: (abs(Fraction(float(c)) - q),
                                     int(np.array(c).view(np.uint32)) & 1))


@pytest.mark.parametrize("lo,hi", [(0.0, 1.0), (1.1, 1.5), (-2.0, 3.0),
                                   (1e6, 1e6 + 1.0), (-3e7, -3e7 + 0.25),
                                   (1e-30, 3.0)])
def test_uniform_multiply_add_rounds_once(lo, hi):
    """``uniform``'s ``f * span + lo`` is rounded to float32 once, as XLA's
    fused multiply-add and the draw kernel's ``__fmaf_rn`` round it: the
    plain version's float64 round-to-odd sum against exact rational
    arithmetic, including bounds where float64 alone would round twice."""
    from fractions import Fraction
    rng = np.random.default_rng(3)
    f = (rng.integers(0, 1 << 23, 4000) * 2.0 ** -23).astype(np.float32)
    lo32, hi32 = np.float32(lo), np.float32(hi)
    span = np.float32(hi32 - lo32)
    got = prng._fma_f32(torch.from_numpy(f), float(span), float(lo32))
    want = np.array([_f32_rounded(Fraction(float(x)) * Fraction(float(span))
                                  + Fraction(float(lo32))) for x in f],
                    np.float32)
    np.testing.assert_array_equal(want, got.numpy())
