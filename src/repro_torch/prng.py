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
dimensions batch independent keys (jax.vmap over keys).
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels.hash import M32, threefry2x32

_ONE_BITS = 0x3F800000       # f32 1.0


def key(seed: int, device=None) -> torch.Tensor:
    """``jax.random.key(seed)`` for an int32 seed."""
    return torch.tensor([0, int(seed) & M32], dtype=torch.int64,
                        device=device)


def _hash(k, c0, c1):
    x0, x1 = threefry2x32(k[..., 0], k[..., 1], c0, c1)
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
    x0, x1 = threefry2x32(k[0], k[1], i >> 32, i & M32)
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
        x0, x1 = threefry2x32(k[..., 0], k[..., 1], 0, 0)
        floats = _bits_to_unit(x0 ^ x1)
    else:
        floats = _bits_to_unit(random_bits(k, tuple(shape)))
    lo = torch.tensor(minval, dtype=torch.float32, device=k.device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=k.device)
    # XLA contracts ``floats * span + lo`` into one fused multiply-add; the
    # product of two float32 is exact in float64, so one float64 multiply-add
    # rounded to float32 gives the fused result
    span = (hi - lo).to(torch.float64)
    out = (floats.to(torch.float64) * span + lo.to(torch.float64)).to(
        torch.float32)
    return torch.maximum(lo, out)


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
