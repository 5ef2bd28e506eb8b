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
dimensions batch independent keys (jax.vmap over keys). On a CUDA tensor the
Threefry runs K0's device function (``kernels/hash.py::threefry_words``), on
a CPU tensor its plain version.

The same derivations on Python ints (``key_words``, ``fold_in_words``,
``split_words``) give a key as a pair of u32 words with no tensor at all:
the per-chunk keys the fused kernels take by value, so that deriving them
copies nothing to the card.
"""
from __future__ import annotations

import math

import torch

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
    """A key of two Python ints as the (2,) int64 tensor the tensor
    functions take (a copy from the host: not for a path that must not wait
    for the card)."""
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
def _hash(k, c0, c1):
    x0, x1 = chash.threefry_words(k[..., 0], k[..., 1], c0, c1)
    return torch.stack(torch.broadcast_tensors(x0, x1), dim=-1)


def fold_in(k, data) -> torch.Tensor:
    """``jax.random.fold_in``; ``data`` an int or an integer tensor (a batch
    of keys, as under vmap), taken mod 2^32."""
    if isinstance(data, torch.Tensor):
        k = k.expand(*data.shape, 2) if k.dim() == 1 else k
        data = data.to(torch.int64) & M32
    else:
        data = int(data) & M32
    return _hash(k, 0, data)


def split(k, num: int = 2) -> torch.Tensor:
    """``jax.random.split(k, num)`` -> (num, 2) keys."""
    i = torch.arange(num, dtype=torch.int64, device=k.device)
    return _hash(k[None, :], 0, i)


def random_bits(k, shape) -> torch.Tensor:
    """32 random bits per element of ``shape`` (int64 holding u32)."""
    size = math.prod(shape)
    i = torch.arange(size, dtype=torch.int64, device=k.device)
    x0, x1 = chash.threefry_words(k[0], k[1], i >> 32, i & M32)
    return (x0 ^ x1).reshape(shape)


def _bits_to_unit(b) -> torch.Tensor:
    """u32 bits -> f32 in [0, 1) by jax's mantissa fill."""
    return ((b >> 9) | _ONE_BITS).to(torch.int32).view(torch.float32) - 1.0


def uniform(k, shape=(), minval: float = 0.0, maxval: float = 1.0):
    """``jax.random.uniform(k, shape, minval=, maxval=)`` in float32. A key
    batch (..., 2) with ``shape=()`` draws one value per key."""
    if k.dim() > 1:
        if shape != ():
            raise ValueError("a batch of keys draws scalar uniforms only")
        x0, x1 = chash.threefry_words(k[..., 0], k[..., 1], 0, 0)
        floats = _bits_to_unit(x0 ^ x1)
    else:
        floats = _bits_to_unit(random_bits(k, tuple(shape)))
    # the bounds as float32, and their span, computed on the host: nothing
    # is copied to the tensor's device
    lo = torch.tensor(minval, dtype=torch.float32)
    hi = torch.tensor(maxval, dtype=torch.float32)
    span = float((hi - lo).to(torch.float64))
    lo = float(lo)
    # XLA contracts ``floats * span + lo`` into one fused multiply-add; the
    # product of two float32 is exact in float64, so one float64 multiply-add
    # rounded to float32 gives the fused result
    out = (floats.to(torch.float64) * span + lo).to(torch.float32)
    return torch.clamp_min(out, lo)


def randint(k, shape, minval: int, maxval: int) -> torch.Tensor:
    """``jax.random.randint(k, shape, minval, maxval)`` for int32 output."""
    k1, k2 = split(k)
    higher = random_bits(k1, tuple(shape))
    lower = random_bits(k2, tuple(shape))
    span = (maxval - minval) & M32 if maxval > minval else 1
    multiplier = (2 ** 16) % span
    multiplier = ((multiplier * multiplier) & M32) % span   # u32 multiply
    off = ((higher % span) * multiplier) & M32
    off = ((off + lower % span) & M32) % span
    return (minval + off).to(torch.int32)
