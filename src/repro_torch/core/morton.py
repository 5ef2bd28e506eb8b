"""Morton (Z-order) codes over the unit cube and the rank decomposition.

The simulation domain [0,1]^3 is split at the *branch level* b — the smallest
b with 8^b >= R ranks — into 8^b subdomains indexed by their Morton code;
each rank owns ``8^b // R`` consecutive subdomains (paper §III-B0a). Integer
bit work runs on int64 tensors (the values stay below 2^30).
"""
from __future__ import annotations

import torch

from repro_torch import prng
from repro_torch.device import resolve_device


def branch_level(num_ranks: int) -> int:
    """Smallest b with 8^b >= R."""
    b = 0
    while 8 ** b < num_ranks:
        b += 1
    return max(b, 1) if num_ranks > 1 else 0


def cells_per_rank(num_ranks: int) -> int:
    return 8 ** branch_level(num_ranks) // num_ranks


def _part1by2(x):
    """Spread the low 10 bits of x so two zeros sit between each."""
    x = x.to(torch.int64) & 0x3FF
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    x = (x | (x << 2)) & 0x09249249
    return x


def _compact1by2(x):
    x = x.to(torch.int64) & 0x09249249
    x = (x ^ (x >> 2)) & 0x030C30C3
    x = (x ^ (x >> 4)) & 0x0300F00F
    x = (x ^ (x >> 8)) & 0x030000FF
    x = (x ^ (x >> 16)) & 0x000003FF
    return x


def morton_encode(pos, level: int):
    """pos: (..., 3) in [0,1) -> Morton cell index at ``level`` (int32)."""
    g = 1 << level
    ijk = torch.clamp((pos * g).to(torch.int32), 0, g - 1)
    code = (_part1by2(ijk[..., 0]) | (_part1by2(ijk[..., 1]) << 1)
            | (_part1by2(ijk[..., 2]) << 2))
    return code.to(torch.int32)


def morton_cell_center(cell, level: int):
    """cell index at ``level`` -> center position (..., 3)."""
    c = cell.to(torch.int64) & 0xFFFFFFFF
    ijk = torch.stack([_compact1by2(c), _compact1by2(c >> 1),
                       _compact1by2(c >> 2)], dim=-1)
    return (ijk.to(torch.float32) + 0.5) / float(1 << level)


def cell_size(level: int) -> float:
    """Cell edge length at octree level (cube => single scalar)."""
    return 1.0 / (1 << level)


def sample_positions_in_cells(key, base_cell: int, n_cells: int, n: int,
                              level: int, device=None):
    """Uniformly sample n positions within Morton cells
    [base_cell, base_cell + n_cells) at ``level`` (a rank's subdomains);
    the reference's jax.random draws, repeated by ``repro_torch.prng``.
    ``key``: a key tensor (its device decides) or two u32 words (on
    ``device``, the card by default); its split is taken on the host, and
    on the card the draws are two launches of K0's draw kernel."""
    dev = key.device if isinstance(key, torch.Tensor) else \
        resolve_device(device)
    kc, kp = prng.split_words(prng.as_words(key))
    cells = base_cell + prng.randint(kc, (n,), 0, n_cells, device=dev)
    centers = morton_cell_center(cells, level)
    off = (prng.uniform(kp, (n, 3), device=dev) - 0.5) * cell_size(level)
    return torch.clamp(centers + off, 0.0, 1.0 - 1e-6)
