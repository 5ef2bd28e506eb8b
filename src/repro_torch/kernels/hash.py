"""K0: the counter-based Threefry-2x32 hash shared by the activity window
(K1) and the Barnes-Hut traversal (K2).

Port of the JAX package's ``kernels/hash.py``: the same 20-round
Threefry-2x32 with the key from ``(seed, domain)`` and the counter from
``(ctr, entity)``, the same 24-bit uniform, Box-Muller normal, Gumbel and
Barnes-Hut counter packing, so every stream is bit-equal to the reference's.

Plain version: int64 tensors holding u32 values, masked with ``& 0xFFFFFFFF``
after every add and shift (``torch.uint32`` has no add or shift on the CPU).
Device version: the ``__device__`` functions of ``csrc/hash.cuh``, inlined
into K1 and K2. ``threefry_words`` runs them elementwise over tensors on the
card through their own small kernel so they can be held against the plain
version.
"""
from __future__ import annotations

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


def threefry2x32(k0, k1, c0, c1):
    """Full 20-round Threefry-2x32: key (k0, k1), counter (c0, c1). Args are
    Python ints or integer tensors (broadcast together); returns two int64
    tensors holding u32 words."""
    dev = _device_of(k0, k1, c0, c1)
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


def bits(seed: int, domain: int, ctr, entity):
    """Two u32 words of hash output for (seed, domain, ctr, entity)."""
    return threefry2x32(seed, domain, ctr, entity)


def _to_unit(word):
    """u32 -> f32 uniform in [0, 1): top 24 bits, exactly representable."""
    return (word >> 8).to(torch.float32) * (2.0 ** -24)


def uniform(seed: int, domain: int, ctr, entity):
    """f32 uniform in [0, 1), elementwise over broadcast(ctr, entity)."""
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
    u = uniform(seed, domain, ctr, entity)
    return -torch.log(-torch.log(torch.clamp_min(u, 1e-20)))


def normal(seed: int, domain: int, ctr, entity):
    """f32 standard normal via Box-Muller on the two hash words."""
    x0, x1 = bits(seed, domain, ctr, entity)
    u1 = _to_unit(x0)
    u2 = _to_unit(x1)
    r = torch.sqrt(-2.0 * torch.log1p(-u1))
    return r * torch.cos(_TWO_PI * u2)


# ------------------------------------------------------------ device check
launches = _build.LaunchCounter("threefry_words")


def threefry_words(k0, k1, c0, c1):
    """Elementwise Threefry-2x32 over four same-shape integer tensors (their
    low 32 bits). A CUDA tensor runs the ``csrc/hash.cuh`` device function
    through the ``threefry_words`` kernel; a CPU tensor runs the plain
    version. Returns two int64 tensors holding u32 words."""
    if k0.device.type != "cuda":
        return threefry2x32(k0, k1, c0, c1)
    shape = k0.shape
    ins = [(t.reshape(-1).to(torch.int64) & M32).to(torch.int32).contiguous()
           for t in (k0, k1, c0, c1)]
    for t in ins[1:]:
        if t.shape != ins[0].shape or t.device != ins[0].device:
            raise ValueError("threefry_words needs four tensors of one shape "
                             "on one device")
    o0 = torch.empty_like(ins[0])
    o1 = torch.empty_like(ins[0])
    lib = _build.library()
    _build.check(lib.repro_threefry_words(
        *(t.data_ptr() for t in ins), o0.data_ptr(), o1.data_ptr(),
        ins[0].numel(), _build.stream()), "threefry_words")
    launches.add()
    return ((o0.to(torch.int64) & M32).reshape(shape),
            (o1.to(torch.int64) & M32).reshape(shape))
