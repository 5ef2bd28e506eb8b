"""K0: the counter-based Threefry-2x32 hash shared by the activity window
(K1) and the Barnes-Hut traversal (K2).

Port of the JAX package's ``kernels/hash.py``: the same 20-round
Threefry-2x32 with the key from ``(seed, domain)`` and the counter from
``(ctr, entity)``, the same 24-bit uniform, Box-Muller normal, Gumbel and
Barnes-Hut counter packing, so every stream is bit-equal to the reference's.

Plain version: int64 tensors holding u32 values, masked with ``& 0xFFFFFFFF``
after every add and shift (``torch.uint32`` has no add or shift on the CPU).
Device version: the ``__device__`` functions of ``csrc/hash.cuh``, inlined
into K1, K2 and ``csrc/retract.cu``, and run over tensors by the draw
kernel of ``csrc/hash_words.cu`` (``draw``): one launch a ``prng`` call on a
CUDA tensor (its keys, bits, uniforms or integers written directly), a
``threefry_words`` call, or a ``uniform``, ``gumbel`` or ``normal`` draw
whose operands include a CUDA tensor, held bit-equal to the plain versions
on the card. No path of the simulator runs the plain ``threefry2x32`` on
a CUDA tensor; ``plain_cuda_calls`` counts such calls, so a check can hold
that count at 0.
``threefry2x32_int`` is the same hash on Python
ints, for keys derived on the host (a few int operations, where the tensor
version would take some sixty small CPU tensor operations).
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build

# Domain separators (arbitrary distinct u32 constants).
NOISE_DOMAIN = 0x6E6F6973    # per-neuron background-noise gaussians
SPIKE_DOMAIN = 0x73706B73    # per-edge Bernoulli(rate) reconstruction
BH_DOMAIN = 0x62687472       # Barnes-Hut traversal/member Gumbel draws

# Barnes-Hut counter layout (see bh_ctr): each chunk owns BH_ROUNDS round
# slots, each round BH_DRAWS draw slots.
BH_ROUNDS = 64
BH_DRAWS = 128

M32 = 0xFFFFFFFF
_PARITY = 0x1BD11BDA         # threefry key-schedule parity constant
_ROT_A = (13, 15, 26, 6)     # rotation schedule, even 4-round groups
_ROT_B = (17, 29, 16, 24)    # rotation schedule, odd 4-round groups
_TWO_PI = 2.0 * 3.14159265358979


def _device_of(*xs):
    for x in xs:
        if isinstance(x, torch.Tensor):
            return x.device
    return torch.device("cpu")


def _u32(x, device):
    """Python int or integer tensor -> int64 tensor holding the u32 bits."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.int64) & M32
    return torch.tensor(int(x) & M32, dtype=torch.int64, device=device)


def _rotl(x, r: int):
    return ((x << r) & M32) | (x >> (32 - r))


_PLAIN_CUDA = [0]


def plain_cuda_calls(reset: bool = False) -> int:
    """Calls of the plain ``threefry2x32`` on CUDA tensors since the last
    reset; ``reset`` sets the count to 0 after reading it."""
    k = _PLAIN_CUDA[0]
    if reset:
        _PLAIN_CUDA[0] = 0
    return k


def threefry2x32(k0, k1, c0, c1):
    """Full 20-round Threefry-2x32: key (k0, k1), counter (c0, c1). Args are
    Python ints or integer tensors (broadcast together); returns two int64
    tensors holding u32 words."""
    dev = _device_of(k0, k1, c0, c1)
    if dev.type == "cuda":
        _PLAIN_CUDA[0] += 1
    k0, k1, x0, x1 = (_u32(v, dev) for v in (k0, k1, c0, c1))
    k2 = k0 ^ k1 ^ _PARITY
    ks = (k0, k1, k2)
    x0 = (x0 + k0) & M32
    x1 = (x1 + k1) & M32
    for g in range(5):
        rots = _ROT_A if g % 2 == 0 else _ROT_B
        for r in rots:
            x0 = (x0 + x1) & M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(g + 1) % 3]) & M32
        x1 = (x1 + ks[(g + 2) % 3] + (g + 1)) & M32
    return x0, x1


def threefry2x32_int(k0: int, k1: int, c0: int, c1: int):
    """The same Threefry-2x32 on Python ints (their low 32 bits): the host's
    derivation of keys that kernels take by value. Returns two ints."""
    ks = (k0 & M32, k1 & M32, (k0 ^ k1 ^ _PARITY) & M32)
    x0 = (c0 + ks[0]) & M32
    x1 = (c1 + ks[1]) & M32
    for g in range(5):
        for r in (_ROT_A if g % 2 == 0 else _ROT_B):
            x0 = (x0 + x1) & M32
            x1 = (((x1 << r) & M32) | (x1 >> (32 - r))) ^ x0
        x0 = (x0 + ks[(g + 1) % 3]) & M32
        x1 = (x1 + ks[(g + 2) % 3] + g + 1) & M32
    return x0, x1


def bits(seed: int, domain: int, ctr, entity):
    """Two u32 words of hash output for (seed, domain, ctr, entity)."""
    return threefry2x32(seed, domain, ctr, entity)


def _to_unit(word):
    """u32 -> f32 uniform in [0, 1): top 24 bits, exactly representable."""
    return (word >> 8).to(torch.float32) * (2.0 ** -24)


def uniform(seed: int, domain: int, ctr, entity):
    """f32 uniform in [0, 1), elementwise over broadcast(ctr, entity)."""
    return _draw_or_plain(UNIT, uniform_plain, seed, domain, ctr, entity)


def uniform_plain(seed: int, domain: int, ctr, entity):
    x0, _ = bits(seed, domain, ctr, entity)
    return _to_unit(x0)


def bh_ctr(chunk, rnd, draw):
    """Pack the Barnes-Hut (chunk, round, draw) triple into one u32 counter
    (int32 arithmetic as in the reference, kept as its u32 bits)."""
    if not isinstance(draw, torch.Tensor):
        draw = torch.as_tensor(draw, dtype=torch.int64)
    return ((int(chunk) * BH_ROUNDS + rnd) * BH_DRAWS + draw.to(torch.int64)) \
        & M32


def gumbel(seed: int, domain: int, ctr, entity):
    """f32 standard Gumbel; u is clamped away from 0 so both logs stay
    finite."""
    return _draw_or_plain(GUMBEL, gumbel_plain, seed, domain, ctr, entity)


def gumbel_plain(seed: int, domain: int, ctr, entity):
    u = uniform_plain(seed, domain, ctr, entity)
    return -torch.log(-torch.log(torch.clamp_min(u, 1e-20)))


def normal(seed: int, domain: int, ctr, entity):
    """f32 standard normal via Box-Muller on the two hash words."""
    return _draw_or_plain(NORMAL, normal_plain, seed, domain, ctr, entity)


def normal_plain(seed: int, domain: int, ctr, entity):
    x0, x1 = bits(seed, domain, ctr, entity)
    u1 = _to_unit(x0)
    u2 = _to_unit(x1)
    r = torch.sqrt(-2.0 * torch.log1p(-u1))
    return r * torch.cos(_TWO_PI * u2)


# ------------------------------------------------------------ device check
launches = _build.LaunchCounter("threefry_words")
_MODE_LAUNCHES = [0] * 8      # launches of the draw kernel by mode

# csrc/hash_words.cu's modes: prng's (WORDS .. RANDINT) and the counter
# hash's uniform, gumbel and normal draws
WORDS, KEYS, BITS, UNIFORM, RANDINT, UNIT, GUMBEL, NORMAL = range(8)
_OUT_DTYPE = (torch.int64, torch.int64, torch.int64, torch.float32,
              torch.int32, torch.float32, torch.float32, torch.float32)


class _Word(ctypes.Structure):
    """One u32 operand of the draw kernel (``csrc/hash_words.cu`` Word)."""
    _fields_ = [("ptr", ctypes.c_void_p), ("stride", ctypes.c_longlong),
                ("inner", ctypes.c_longlong), ("outer", ctypes.c_longlong),
                ("is64", ctypes.c_int), ("value", ctypes.c_uint)]


class _DrawArgs(ctypes.Structure):
    """The draw kernel's parameters (``csrc/hash_words.cu`` DrawArgs)."""
    _fields_ = [("k0", _Word), ("k1", _Word), ("c0", _Word), ("c1", _Word),
                ("flat_counter", ctypes.c_int), ("mode", ctypes.c_int),
                ("n", ctypes.c_longlong), ("out", ctypes.c_void_p),
                ("lo", ctypes.c_float), ("span", ctypes.c_float),
                ("span_u", ctypes.c_uint), ("multiplier", ctypes.c_uint),
                ("minval", ctypes.c_uint)]


def _layout(x: torch.Tensor, shape):
    """Where ``x`` broadcast to ``shape`` holds element i of the row-major
    flat index, in elements: ``(stride, 0, 0)`` for i * stride, or
    ``(stride, inner, outer)`` for (i % inner) * stride + (i // inner) *
    outer (a (Q, 1) column or a (1, F) row broadcast over a (Q, F) grid);
    None where no two strides do."""
    xs = x.expand(shape)
    runs = []          # [stride, elements] of merged axes, innermost first
    for size, st in zip(reversed(xs.shape), reversed(xs.stride())):
        if size == 1:
            continue
        if runs and st == runs[-1][0] * runs[-1][1]:
            runs[-1][1] *= size
        else:
            runs.append([st, size])
    if len(runs) > 2:
        return None
    if len(runs) == 2:
        return runs[0][0], runs[0][1], runs[1][0]
    return (runs[0][0] if runs else 0), 0, 0


def _word(x, shape, dev) -> _Word:
    """The draw kernel's operand for a Python int or an integer tensor over
    ``shape``: its value, or its data read where it lies through one or two
    strides (int32 or int64, u32 and u64 too). Other element sizes and
    layouts no two strides read raise: nothing is copied."""
    if not isinstance(x, torch.Tensor):
        return _Word(None, 0, 0, 0, 0, int(x) & M32)
    if x.device != dev:
        raise ValueError("threefry: every tensor operand must lie on the "
                         f"output's device {dev}, got {x.device}")
    if x.dtype.is_floating_point or x.dtype.is_complex or \
            x.element_size() not in (4, 8):
        raise TypeError(f"threefry: 32- or 64-bit integer operands only, "
                        f"got {x.dtype}")
    layout = _layout(x, shape)
    if layout is None:
        raise ValueError(f"threefry: an operand of shape {tuple(x.shape)} "
                         f"and strides {x.stride()} is not two strides over "
                         f"{shape}")
    if layout[1] and math.prod(shape) >= 2 ** 32:
        raise ValueError(f"threefry: a two-stride operand over {shape} (the "
                         f"kernel indexes it in 32 bits)")
    return _Word(x.data_ptr(), *layout, int(x.element_size() == 8), 0)


def draw(mode: int, k0, k1, c0, c1, shape, dev, *, lo: float = 0.0,
         span: float = 0.0, span_u: int = 1, multiplier: int = 0,
         minval: int = 0):
    """One launch of K0's draw kernel over ``shape`` on the CUDA device
    ``dev``: operands are Python ints or integer tensors broadcast to
    ``shape`` (keys: the shape of the key batch); ``c0 = None`` makes the
    counter the flat index. Returns the mode's output: (2, *shape) int64
    words, (*shape, 2) int64 keys, int64 bits, f32 uniforms, int32
    integers, or f32 counter-hash uniforms, Gumbels or normals."""
    if dev.type != "cuda":
        raise ValueError(f"threefry draw: a CUDA device, not {dev}")
    shape = tuple(shape)
    n = math.prod(shape)
    out_shape = {WORDS: (2, *shape), KEYS: (*shape, 2)}.get(mode, shape)
    out = torch.empty(out_shape, dtype=_OUT_DTYPE[mode], device=dev)
    if n == 0:
        return out
    flat = c0 is None
    args = _DrawArgs(
        _word(k0, shape, dev), _word(k1, shape, dev),
        _Word() if flat else _word(c0, shape, dev),
        _Word() if flat else _word(c1, shape, dev),
        int(flat), mode, n, out.data_ptr(), lo, span, span_u & M32,
        multiplier & M32, minval & M32)
    _build.check(_build.library().repro_threefry_draw(
        ctypes.addressof(args), _build.stream(dev.index)), "threefry")
    launches.add()
    _MODE_LAUNCHES[mode] += 1
    return out


def mode_launches(reset: bool = False) -> dict:
    """The wrapper's launches of the draw kernel by mode name since the last
    reset (``launches`` counts them all); ``reset`` sets them to 0."""
    names = ("words", "keys", "bits", "uniform", "randint", "unit", "gumbel",
             "normal")
    out = dict(zip(names, _MODE_LAUNCHES))
    if reset:
        _MODE_LAUNCHES[:] = [0] * len(names)
    return out


def device_launches(reset: bool = False) -> int:
    """Launches of the draw kernel counted in ``csrc/hash_words.cu`` since
    the last reset."""
    return _build.library().repro_threefry_device_launches(int(reset))


def threefry_words(k0, k1, c0, c1):
    """Elementwise Threefry-2x32 over four operands (integer tensors that
    broadcast together, or Python ints; their low 32 bits). When one of them
    is a CUDA tensor this is one launch of K0's draw kernel, which reads each
    tensor where it lies (int32 or int64, through one or two strides; other
    operands raise); otherwise the plain version. Returns two int64 tensors holding u32 words."""
    dev = _device_of(k0, k1, c0, c1)
    if dev.type != "cuda":
        return threefry2x32(k0, k1, c0, c1)
    shape = torch.broadcast_shapes(*(t.shape for t in (k0, k1, c0, c1)
                                     if isinstance(t, torch.Tensor)))
    out = draw(WORDS, k0, k1, c0, c1, shape, dev)
    return out[0], out[1]


def _draw_or_plain(mode: int, plain, *operands):
    """A counter-hash draw (``UNIT``, ``GUMBEL`` or ``NORMAL``): one launch
    of the draw kernel when an operand is a CUDA tensor, else ``plain``."""
    dev = _device_of(*operands)
    if dev.type != "cuda":
        return plain(*operands)
    shape = torch.broadcast_shapes(*(t.shape for t in operands
                                     if isinstance(t, torch.Tensor)))
    return draw(mode, *operands, shape, dev)
