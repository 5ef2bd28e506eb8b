"""jax.random's threefry key derivation, as the reference uses it.

The JAX package draws its initial positions, vacant elements and the
retraction/acceptance priorities from ``jax.random`` with the ``threefry2x32``
implementation and ``jax_threefry_partitionable=True``. This module repeats
those derivations on torch tensors so the port draws the very same numbers:

  key(seed)        -> (0, seed mod 2^32)
  fold_in(k, d)    -> threefry(k, (0, d))
  split(k, num)[i] -> threefry(k, (0, i))
  random_bits(k, shape)[i] = x0 ^ x1 of threefry(k, (i >> 32, i mod 2^32))
                     over the row-major flat index i
  uniform          -> (bits >> 9 | 0x3F800000) as f32, minus 1, scaled
  randint          -> two split keys, 32-bit high/low words folded mod span

A key is an int64 tensor of shape (..., 2) holding two u32 words; leading
dimensions batch independent keys (jax.vmap over keys). The same derivations
on Python ints (``key_words``, ``fold_in_words``, ``split_words``) give a key
as a pair of u32 words with no tensor at all: the per-chunk keys the fused
kernels take by value, and ``init_state``'s keys, so that deriving them
copies nothing to the card.

The tensor functions (``fold_in``, ``split``, ``random_bits``, ``uniform``,
``randint``) take either form of key; with no tensor operand they run on
``device``, the card unless the caller names another. On a CUDA device each
call is one
launch of K0's draw kernel (``kernels/hash.py::draw``, ``csrc/hash_words.cu``),
which reads the key and data where they lie and writes the final tensor; on
the CPU they run the plain version, the int64 Threefry of
``kernels/hash.py::threefry2x32``.
"""
from __future__ import annotations

import math

import torch

from repro_torch.device import resolve_device
from repro_torch.kernels import hash as chash
from repro_torch.kernels.hash import M32

_ONE_BITS = 0x3F800000       # f32 1.0


def key(seed: int, device=None) -> torch.Tensor:
    """``jax.random.key(seed)`` for an int32 seed."""
    return key_tensor(key_words(seed), device)


# ------------------------------------------------------- keys as host words
def key_words(seed: int) -> tuple:
    """``jax.random.key(seed)`` as two Python ints."""
    return (0, int(seed) & M32)


def fold_in_words(k: tuple, data: int) -> tuple:
    """``jax.random.fold_in`` on a key of two Python ints."""
    return chash.threefry2x32_int(k[0], k[1], 0, int(data) & M32)


def split_words(k: tuple, num: int = 2) -> tuple:
    """``jax.random.split(k, num)`` on a key of two Python ints: ``num``
    keys."""
    return tuple(chash.threefry2x32_int(k[0], k[1], 0, i)
                 for i in range(num))


def key_tensor(words, device=None) -> torch.Tensor:
    """A key of two Python ints as a (2,) int64 key tensor (a copy from the
    host: not for a path that must not wait for the card)."""
    return torch.tensor([int(words[0]) & M32, int(words[1]) & M32],
                        dtype=torch.int64, device=device)


def as_key(k, device=None) -> torch.Tensor:
    """A key tensor, from a key tensor or a pair of Python ints."""
    return k if isinstance(k, torch.Tensor) else key_tensor(k, device)


def as_words(k) -> tuple:
    """A key as two Python ints, from a pair of ints or a (2,) key tensor
    (read back from its device)."""
    if isinstance(k, torch.Tensor):
        if k.shape != (2,):
            raise ValueError(f"one key of two words, not shape {k.shape}")
        return tuple(int(v) & M32 for v in k.tolist())
    return (int(k[0]) & M32, int(k[1]) & M32)


# ------------------------------------------------------------ tensor keys
# Each function takes a key as a (..., 2) tensor or as two Python ints. It
# runs on a tensor operand's device, else on ``device`` (the card when None,
# ``device.resolve_device``, raising without one). On a CUDA device it is one
# launch of K0's draw kernel, which writes the final tensor
# (``kernels/hash.py::draw``); on the CPU the plain version below.
def _device(k, data, device) -> torch.device:
    for x in (k, data):
        if isinstance(x, torch.Tensor):
            return x.device
    return resolve_device(device)


def _key_words(k):
    """The key's two words as draw operands: Python ints, or the (...,)
    views of a key tensor's columns."""
    if isinstance(k, torch.Tensor):
        return k[..., 0], k[..., 1]
    return int(k[0]) & M32, int(k[1]) & M32


def _hash(k, c0, c1):
    x0, x1 = chash.threefry2x32(k[..., 0], k[..., 1], c0, c1)
    return torch.stack(torch.broadcast_tensors(x0, x1), dim=-1)


def fold_in(k, data, device=None) -> torch.Tensor:
    """``jax.random.fold_in``; ``data`` an int or an integer tensor (a batch
    of keys, as under vmap), taken mod 2^32."""
    dev = _device(k, data, device)
    if dev.type != "cuda":
        return fold_in_plain(as_key(k, dev), data)
    batch = k.shape[:-1] if isinstance(k, torch.Tensor) else ()
    shape = torch.broadcast_shapes(
        batch, data.shape if isinstance(data, torch.Tensor) else ())
    return chash.draw(chash.KEYS, *_key_words(k), 0, data, shape, dev)


def split(k, num: int = 2, device=None) -> torch.Tensor:
    """``jax.random.split(k, num)`` -> (num, 2) keys."""
    dev = _device(k, None, device)
    if dev.type != "cuda":
        return split_plain(as_key(k, dev), num)
    return chash.draw(chash.KEYS, *_key_words(k), None, None, (num,), dev)


def random_bits(k, shape, device=None) -> torch.Tensor:
    """32 random bits per element of ``shape`` (int64 holding u32)."""
    dev = _device(k, None, device)
    if dev.type != "cuda":
        return random_bits_plain(as_key(k, dev), shape)
    return chash.draw(chash.BITS, *_key_words(k), None, None, shape, dev)


def uniform(k, shape=(), minval: float = 0.0, maxval: float = 1.0,
            device=None):
    """``jax.random.uniform(k, shape, minval=, maxval=)`` in float32. A key
    batch (..., 2) with ``shape=()`` draws one value per key."""
    dev = _device(k, None, device)
    if dev.type != "cuda":
        return uniform_plain(as_key(k, dev), shape, minval, maxval)
    lo, span = _bounds(minval, maxval)
    if isinstance(k, torch.Tensor) and k.dim() > 1:
        if tuple(shape) != ():
            raise ValueError("a batch of keys draws scalar uniforms only")
        return chash.draw(chash.UNIFORM, *_key_words(k), 0, 0, k.shape[:-1],
                          dev, lo=lo, span=span)
    return chash.draw(chash.UNIFORM, *_key_words(k), None, None, shape, dev,
                      lo=lo, span=span)


def randint(k, shape, minval: int, maxval: int, device=None) -> torch.Tensor:
    """``jax.random.randint(k, shape, minval, maxval)`` for int32 output."""
    dev = _device(k, None, device)
    if dev.type != "cuda":
        return randint_plain(as_key(k, dev), shape, minval, maxval)
    span, multiplier = _randint_span(minval, maxval)
    return chash.draw(chash.RANDINT, *_key_words(k), None, None, shape, dev,
                      span_u=span, multiplier=multiplier, minval=minval)


# ------------------------------------------------------- the plain versions
# The same functions on key tensors of any device in int64 torch ops: what
# the CPU runs, and what the card holds the draw kernel against.
def fold_in_plain(k, data) -> torch.Tensor:
    if isinstance(data, torch.Tensor):
        k = k.expand(*data.shape, 2) if k.dim() == 1 else k
        data = data.to(torch.int64) & M32
    else:
        data = int(data) & M32
    return _hash(k, 0, data)


def split_plain(k, num: int = 2) -> torch.Tensor:
    i = torch.arange(num, dtype=torch.int64, device=k.device)
    return _hash(k[None, :], 0, i)


def random_bits_plain(k, shape) -> torch.Tensor:
    i = torch.arange(math.prod(shape), dtype=torch.int64, device=k.device)
    x0, x1 = chash.threefry2x32(k[0], k[1], i >> 32, i & M32)
    return (x0 ^ x1).reshape(shape)


def _bits_to_unit(b) -> torch.Tensor:
    """u32 bits -> f32 in [0, 1) by jax's mantissa fill."""
    return ((b >> 9) | _ONE_BITS).to(torch.int32).view(torch.float32) - 1.0


def _fma_f32(x, span: float, lo: float) -> torch.Tensor:
    """float32 ``x * span + lo`` rounded once, as XLA contracts it into a
    fused multiply-add (and the draw kernel's ``__fmaf_rn``). The product
    of two float32 is exact in float64; the float64 sum is made round-to-odd
    (its error, from TwoSum, sets the last bit), so rounding it to float32
    rounds the exact value once."""
    p = x.to(torch.float64) * span
    s = p + lo
    b = s - p
    err = (p - (s - b)) + (lo - b)
    bits = s.view(torch.int64)
    toward = torch.where((err > 0) == (s > 0), 1, -1)
    bits = torch.where((err != 0) & ((bits & 1) == 0), bits + toward, bits)
    return bits.view(torch.float64).to(torch.float32)


def _bounds(minval: float, maxval: float):
    """The bounds as float32 and their float32 span, on the host: nothing is
    copied to a device."""
    lo = torch.tensor(minval, dtype=torch.float32)
    hi = torch.tensor(maxval, dtype=torch.float32)
    return float(lo), float(hi - lo)


def uniform_plain(k, shape=(), minval: float = 0.0, maxval: float = 1.0):
    lo, span = _bounds(minval, maxval)
    if k.dim() > 1:
        if tuple(shape) != ():
            raise ValueError("a batch of keys draws scalar uniforms only")
        x0, x1 = chash.threefry2x32(k[..., 0], k[..., 1], 0, 0)
        floats = _bits_to_unit(x0 ^ x1)
    else:
        floats = _bits_to_unit(random_bits_plain(k, tuple(shape)))
    return torch.clamp_min(_fma_f32(floats, span, lo), lo)


def _randint_span(minval: int, maxval: int):
    """jax.random.randint's u32 span and the multiplier 2^32 mod span."""
    span = (maxval - minval) & M32 if maxval > minval else 1
    multiplier = (2 ** 16) % span
    return span, ((multiplier * multiplier) & M32) % span   # u32 multiply


def randint_plain(k, shape, minval: int, maxval: int) -> torch.Tensor:
    span, multiplier = _randint_span(minval, maxval)
    k1, k2 = split_plain(k)
    higher = random_bits_plain(k1, tuple(shape))
    lower = random_bits_plain(k2, tuple(shape))
    off = ((higher % span) * multiplier) & M32
    off = ((off + lower % span) & M32) % span
    return (minval + off).to(torch.int32)
