"""K9: causal / sliding-window GQA attention forward with an online softmax.

``flash_attention_plain`` is the JAX package's ``kernels/ref.py::
attention_ref``: the naive full softmax in float32 over K and V repeated to
the q heads (kv head = q head // (Hq // Hkv)), masked scores set to
NEG = -1e30, top-left positions (k_pos <= q_pos for causal, q_pos - k_pos <
window for a window), the output cast to q's dtype. ``flash_attention_fwd``
is the wrapper of the hand-written CUDA kernels ``csrc/flash_attention.cu``:
on a CUDA tensor it launches one of them or raises (a dtype other than
f32/bf16, or a head dimension that is not a multiple of 16 in [16, 256]); on
a CPU tensor it runs the plain version. ``kernel_for`` picks the kernel from
the dtype and head dimension alone, before any launch: bf16 at D = 64, 128
or 256 runs on ``wgmma`` with TMA loads, other bf16 head dimensions on
``mma.sync``, f32 on FFMA. ``scale`` multiplies the scores (1/sqrt(D) when
None): the LM's prefill passes a q it pre-scaled and rounded as the JAX
model does, with ``scale=1.0``.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import _build

NEG = -1e30

launches = _build.LaunchCounter("flash_attention")
WGMMA_HEAD_DIMS = (64, 128, 256)
KERNELS = ("wgmma_bf16", "mma_sync_bf16", "ffma_f32")


def kernel_for(dtype, d: int) -> str:
    """The kernel that takes q of this dtype and head dimension."""
    if dtype == torch.float32:
        return "ffma_f32"
    return "wgmma_bf16" if d in WGMMA_HEAD_DIMS else "mma_sync_bf16"


def device_launches(*, reset: bool = False) -> dict:
    """Launches of each kernel on the card, counted in
    ``csrc/flash_attention.cu`` beside each launch (not by this wrapper);
    ``reset`` sets the counts to 0 after reading them."""
    lib = _build.library()
    return {name: int(lib.repro_flash_attention_device_launches(i, int(reset)))
            for i, name in enumerate(KERNELS)}


def _window(window, s: int) -> int:
    """The window as the kernel takes it: 0 for none; a window of at least S
    masks nothing (q_pos - k_pos <= S - 1)."""
    return int(window) if window and 0 < window < s else 0


def _probs(q, k, causal, window, scale=None):
    """The full softmax in float32: (B, Hq, S, Skv)."""
    hq, sq, d = q.shape[1], q.shape[2], q.shape[3]
    skv = k.shape[2]
    f32 = torch.float32
    kf = torch.repeat_interleave(k, hq // k.shape[1], dim=1).to(f32)
    s = torch.einsum("bhqd,bhkd->bhqk", q.to(f32), kf)
    if scale is None:
        s = s / torch.sqrt(torch.tensor(float(d), dtype=f32,
                                        device=q.device))
    else:
        s = s * float(scale)
    qpos = torch.arange(sq, device=q.device)[:, None]
    kpos = torch.arange(skv, device=q.device)[None, :]
    ok = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        ok &= kpos <= qpos
    if window and window > 0:
        ok &= qpos - kpos < window
    s = torch.where(ok, s, torch.tensor(NEG, dtype=f32, device=q.device))
    return torch.softmax(s, dim=-1)


def _values(v, hq):
    return torch.repeat_interleave(v, hq // v.shape[1], dim=1).to(
        torch.float32)


def flash_attention_plain(q, k, v, *, causal=True, window=0, scale=None):
    """q: (B, Hq, S, D); k, v: (B, Hkv, Skv, D) -> (B, Hq, S, D) in q's
    dtype; scores scaled by ``scale`` (1/sqrt(D) when None)."""
    p = _probs(q, k, causal, window, scale)
    return torch.einsum("bhqk,bhkd->bhqd", p, _values(v, q.shape[1])).to(
        q.dtype)


def bf16_error_bound(plain, q, k, v, *, causal=True, window=0,
                     scale=None):
    """Per output element, how far the bf16 kernel may lie from ``plain``
    (the plain version's output on the same bf16 inputs): 2**-7 |plain|
    for the two roundings of the output to bf16 (one ulp), plus
    2**-6 sqrt(sum_j p_j^2 v_j^2) for the kernel's rounding of each p_j to
    bf16 before P V (relative error at most 2**-9 each). That second term
    is a hard bound for rows of at most 64 keys and about 14 standard
    deviations of the rounding sum for longer rows, where a fixed tolerance
    would be as large as the output itself. ``scale`` as in
    ``flash_attention_plain``."""
    p = _probs(q, k, causal, window, scale)
    spread = torch.einsum("bhqk,bhkd->bhqd", p * p,
                          _values(v, q.shape[1]).square()).sqrt()
    return 2.0 ** -7 * plain.float().abs() + 2.0 ** -6 * spread


def flash_attention_fwd(q, k, v, *, causal=True, window=0, scale=None):
    """Attention forward (K9); shapes and ``scale`` as
    ``flash_attention_plain``. A row
    with no valid key (only with a window, when q_pos >= Skv + window - 1)
    gets the plain version's answer, the mean of V over all keys."""
    if q.device.type != "cuda":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     scale=scale)
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError("flash_attention: q (B, Hq, S, D), k and v "
                         "(B, Hkv, Skv, D)")
    b, hq, s, d = q.shape
    _, hkv, skv, dk = k.shape
    if k.shape[0] != b or dk != d or hkv == 0 or hq % hkv:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} and k "
                         f"{tuple(k.shape)} do not agree (Hq must be a "
                         f"multiple of Hkv)")
    if q.dtype not in (torch.float32, torch.bfloat16) or \
            k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: q, k, v must all be float32 or "
                        f"all bfloat16, got {q.dtype}, {k.dtype}, {v.dtype}")
    if d % 16 or not 16 <= d <= 256:
        raise ValueError(f"flash_attention: head dimension {d} is not a "
                         f"multiple of 16 in [16, 256]")
    if skv == 0:
        raise ValueError("flash_attention: no keys")
    kernel = kernel_for(q.dtype, d)
    qc, kc, vc = (t.contiguous() for t in (q, k, v))
    if kernel == "wgmma_bf16":
        # TMA reads from 16-byte aligned bases only: a view that starts
        # mid-row is copied (the allocator's own tensors are aligned)
        qc, kc, vc = (t if t.data_ptr() % 16 == 0 else t.clone()
                      for t in (qc, kc, vc))
    out = torch.empty_like(qc)
    _build.require_cuda("flash_attention", qc, kc, vc, out)
    lib = _build.library()
    args = (qc.data_ptr(), kc.data_ptr(), vc.data_ptr(), out.data_ptr(), b,
            hq, hkv, s, skv, d, int(bool(causal)), _window(window, s),
            1.0 / math.sqrt(d) if scale is None else float(scale))
    if kernel == "wgmma_bf16":
        rc = lib.repro_flash_attention_wgmma(*args, _build.stream())
    else:
        rc = lib.repro_flash_attention(
            *args, int(q.dtype == torch.bfloat16), _build.stream())
    _build.check(rc, "flash_attention")
    launches.add()
    return out
