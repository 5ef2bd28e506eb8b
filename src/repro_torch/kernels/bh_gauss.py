"""K7: the pairwise Gaussian connection probabilities of the public kernel
API, P[i, j] = w[j] * exp(-||x_i - y_j||^2 / sigma^2), and the row sums.

``bh_gauss_plain`` computes the distance as the JAX package's
``kernels/bh_gauss.py`` does, |x|^2 + |y|^2 - 2 x.y clamped at 0, in float32,
with each of the three sums written as an ordered sum of the lane products
(not a matrix product), and the Gaussian as ``connectome/traverse.py::_gauss``
(a true division by sigma^2). ``bh_gauss_probs`` is the wrapper of the
hand-written CUDA kernel ``csrc/bh_gauss.cu``: on a CUDA tensor it launches
the kernel or raises; on a CPU tensor it runs the plain version. On the card
the kernel's P equals the plain version's bit for bit; the row sums are
taken in another (fixed) order.
"""
from __future__ import annotations

import torch

from repro_torch.connectome.traverse import _gauss
from repro_torch.kernels import _build

TILE_M = 256        # candidates a block of csrc/bh_gauss.cu

launches = _build.LaunchCounter("bh_gauss_probs")


def _sq(a):
    return a[:, 0] * a[:, 0] + a[:, 1] * a[:, 1] + a[:, 2] * a[:, 2]


def bh_gauss_plain(x, y, w, *, sigma: float):
    """x: (N, 3) searchers; y: (M, 3) candidates; w: (M,) weights. Returns
    (P (N, M) f32, rowsum (N,) f32)."""
    x, y, w = (t.to(torch.float32) for t in (x, y, w))
    xy = x[:, None, 0] * y[None, :, 0] + x[:, None, 1] * y[None, :, 1] \
        + x[:, None, 2] * y[None, :, 2]
    d2 = torch.clamp_min(_sq(x)[:, None] + _sq(y)[None, :] - 2.0 * xy, 0.0)
    p = w[None, :] * _gauss(d2, sigma)
    return p, torch.sum(p, dim=-1)


def bh_gauss_probs(x, y, w, *, sigma: float):
    """P and its row sums (K7); shapes as ``bh_gauss_plain``."""
    if x.device.type != "cuda":
        return bh_gauss_plain(x, y, w, sigma=sigma)
    if x.dim() != 2 or x.shape[1] != 3 or y.dim() != 2 or y.shape[1] != 3 \
            or w.shape != (y.shape[0],):
        raise ValueError("bh_gauss_probs: x (N, 3), y (M, 3) and w (M,)")
    n, m = x.shape[0], y.shape[0]
    dev = x.device
    f32 = torch.float32
    xs, ys, ws = (t.to(f32).contiguous() for t in (x, y, w))
    tiles = -(-m // TILE_M)
    p = torch.empty((n, m), dtype=f32, device=dev)
    # per-(row, column tile) partial sums, summed in tile order
    partial = torch.empty((n, tiles), dtype=f32, device=dev)
    rowsum = torch.empty(n, dtype=f32, device=dev)
    _build.require_cuda("bh_gauss_probs", xs, ys, ws, p, partial, rowsum)
    lib = _build.library()
    _build.check(lib.repro_bh_gauss(
        xs.data_ptr(), ys.data_ptr(), ws.data_ptr(), p.data_ptr(),
        partial.data_ptr(), rowsum.data_ptr(), n, m, tiles,
        float(sigma * sigma), _build.stream()), "bh_gauss_probs")
    launches.add()
    return p, rowsum
