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
``mma.sync``; f32 at D = 64 or 128 on TF32 ``wgmma`` with three products to
the product (``csrc/flash_attention_tf32.cu``, after its pre-pass
``split_tf32``), other f32 head dimensions on FFMA. ``kernel_launches``
gives each kernel's launches a call. ``scale`` multiplies the scores
(1/sqrt(D) when None): the LM's prefill passes a q it pre-scaled and rounded
as the JAX model does, with ``scale=1.0``.

K9's backward (``flash_attention_bwd``) is new in the port: the JAX package
differentiates its plain attention, so no TPU kernel stands behind it. It
takes the row logsumexp that the forward writes when asked
(``return_lse=True``) and gives dQ, dK, dV, the gradient of
``flash_attention_plain``, whose plain counterpart is
``flash_attention_plain_bwd`` (autograd through it). ``bwd_kernel_for``
picks its kernels from the dtype and head dimension alone, as
``kernel_for`` does: bf16 at D = 64, 128 or 256 on ``wgmma`` with TMA loads
(``csrc/flash_attention_bwd_wgmma.cu``: dq, dkdv a block per q head, and
the group sum when Hq > Hkv), f32 at D = 64 or 128 on TF32 ``wgmma``
(``csrc/flash_attention_tf32.cu``: the pre-pass, dq, dkdv, the group sum
when Hq > Hkv), other bf16 head dimensions on ``mma.sync`` and other f32
ones on FFMA (``csrc/flash_attention_bwd.cu``). ``flash_attention``
runs the forward and backward as one ``torch.autograd.Function`` when a
gradient is wanted.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import _build

NEG = -1e30

launches = _build.LaunchCounter("flash_attention")
bwd_launches = _build.LaunchCounter("flash_attention_bwd")
WGMMA_HEAD_DIMS = (64, 128, 256)
TF32_HEAD_DIMS = (64, 128)
KERNELS = ("wgmma_bf16", "mma_sync_bf16", "ffma_f32", "wgmma_tf32x3",
           "split_tf32")
BWD_KERNELS = ("dq_bf16", "dkdv_bf16", "dq_f32", "dkdv_f32", "dq_wgmma",
               "dkdv_wgmma", "group_sum", "split_tf32", "dq_tf32x3",
               "dkdv_tf32x3", "group_sum_f32")


def kernel_for(dtype, d: int) -> str:
    """The kernel that takes q of this dtype and head dimension."""
    if dtype == torch.float32:
        return "wgmma_tf32x3" if d in TF32_HEAD_DIMS else "ffma_f32"
    return "wgmma_bf16" if d in WGMMA_HEAD_DIMS else "mma_sync_bf16"


def kernel_launches(dtype, d: int) -> dict:
    """Each forward kernel's launches a call (``KERNELS``' names): the
    kernel ``kernel_for`` names, after its pre-pass ``split_tf32`` on
    TF32."""
    kernel = kernel_for(dtype, d)
    per = {kernel: 1}
    if kernel == "wgmma_tf32x3":
        per["split_tf32"] = 1
    return {name: per.get(name, 0) for name in KERNELS}


def launches_per_call(dtype, d: int) -> int:
    """The forward's kernel launches a call (``kernel_launches``)."""
    return sum(kernel_launches(dtype, d).values())


def device_launches(*, reset: bool = False) -> dict:
    """Launches of each kernel on the card, counted in
    ``csrc/flash_attention.cu`` (the first three of ``KERNELS``) and
    ``csrc/flash_attention_tf32.cu`` (the last two) beside each launch (not
    by this wrapper); ``reset`` sets the counts to 0 after reading them."""
    lib = _build.library()
    counts = [lib.repro_flash_attention_device_launches(i, int(reset))
              for i in range(3)]
    counts += [lib.repro_flash_attention_tf32x3_device_launches(
        i, int(reset)) for i in (1, 0)]
    return {name: int(n) for name, n in zip(KERNELS, counts)}


def bwd_device_launches(*, reset: bool = False) -> dict:
    """Launches of each backward kernel on the card, counted in
    ``csrc/flash_attention_bwd.cu`` (the first four of ``BWD_KERNELS``),
    ``csrc/flash_attention_bwd_wgmma.cu`` (the next three) and
    ``csrc/flash_attention_tf32.cu`` (the last four); ``reset`` as
    ``device_launches``."""
    lib = _build.library()
    counts = [lib.repro_flash_attention_bwd_device_launches(i, int(reset))
              for i in range(4)]
    counts += [lib.repro_flash_attention_bwd_wgmma_device_launches(
        i, int(reset)) for i in range(3)]
    counts += [lib.repro_flash_attention_tf32x3_device_launches(
        i, int(reset)) for i in range(2, 6)]
    return {name: int(n) for name, n in zip(BWD_KERNELS, counts)}


def bwd_kernel_for(dtype, d: int) -> str:
    """The backward kernels that take q of this dtype and head dimension,
    by the forward's names: ``wgmma_bf16`` (dq_wgmma, dkdv_wgmma,
    group_sum), ``mma_sync_bf16`` (dq_bf16, dkdv_bf16), ``wgmma_tf32x3``
    (split_tf32, dq_tf32x3, dkdv_tf32x3, group_sum_f32) or ``ffma_f32``
    (dq_f32, dkdv_f32)."""
    return kernel_for(dtype, d)


def bwd_kernel_launches(dtype, d: int, group: int = 1) -> dict:
    """Each backward kernel's launches a call (``BWD_KERNELS``' names):
    dQ, then dK and dV; on wgmma a group sum when ``group`` (Hq / Hkv) > 1,
    on TF32 also the pre-pass first, on mma.sync at D > 128 dK and dV
    apart."""
    kernel = bwd_kernel_for(dtype, d)
    if kernel == "wgmma_bf16":
        per = {"dq_wgmma": 1, "dkdv_wgmma": 1, "group_sum": int(group > 1)}
    elif kernel == "wgmma_tf32x3":
        per = {"split_tf32": 1, "dq_tf32x3": 1, "dkdv_tf32x3": 1,
               "group_sum_f32": int(group > 1)}
    elif kernel == "mma_sync_bf16":
        per = {"dq_bf16": 1, "dkdv_bf16": 2 if d > 128 else 1}
    else:
        per = {"dq_f32": 1, "dkdv_f32": 1}
    return {name: per.get(name, 0) for name in BWD_KERNELS}


def bwd_launches_per_call(dtype, d: int, group: int = 1) -> int:
    """The backward's kernel launches a call (``bwd_kernel_launches``)."""
    return sum(bwd_kernel_launches(dtype, d, group).values())


def _pad8(n: int) -> int:
    return (n + 7) // 8 * 8


def _tf32_scratch(device, *shapes):
    """One f32 allocation cut into views of the given shapes (each a
    multiple of 4 elements, so each view's base stays 16-byte aligned): the
    TF32 kernels' hi and lo halves."""
    sizes = [math.prod(s) for s in shapes]
    flat = torch.empty(sum(sizes), dtype=torch.float32, device=device)
    return [v.view(s) for v, s in zip(flat.split(sizes), shapes)]


def _aligned(*ts):
    """TMA and float4 loads read from 16-byte aligned bases only: a view
    that starts mid-row is copied (the allocator's own tensors are
    aligned)."""
    return [t if t.data_ptr() % 16 == 0 else t.clone() for t in ts]


def _window(window, s: int) -> int:
    """The window as the kernel takes it: 0 for none; a window of at least S
    masks nothing (q_pos - k_pos <= S - 1)."""
    return int(window) if window and 0 < window < s else 0


def _scores(q, k, causal, window, scale=None):
    """The scaled scores in float32, masked ones set to NEG: (B, Hq, S,
    Skv)."""
    hq, sq, d = q.shape[1], q.shape[2], q.shape[3]
    skv = k.shape[2]
    f32 = _compute_dtype(q)
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
    return torch.where(ok, s, torch.tensor(NEG, dtype=f32, device=q.device))


def _probs(q, k, causal, window, scale=None):
    """The full softmax in float32: (B, Hq, S, Skv)."""
    return torch.softmax(_scores(q, k, causal, window, scale), dim=-1)


def _compute_dtype(x):
    """float32, or float64 for a float64 evaluation of the same function."""
    return torch.float64 if x.dtype == torch.float64 else torch.float32


def _values(v, hq):
    return torch.repeat_interleave(v, hq // v.shape[1], dim=1).to(
        _compute_dtype(v))


def flash_attention_plain(q, k, v, *, causal=True, window=0, scale=None):
    """q: (B, Hq, S, D); k, v: (B, Hkv, Skv, D) -> (B, Hq, S, D) in q's
    dtype; scores scaled by ``scale`` (1/sqrt(D) when None)."""
    p = _probs(q, k, causal, window, scale)
    return torch.einsum("bhqk,bhkd->bhqd", p, _values(v, q.shape[1])).to(
        q.dtype)


def lse_plain(q, k, *, causal=True, window=0, scale=None):
    """Each row's logsumexp of its scaled scores, float32 (B, Hq, S): what
    the forward writes with ``return_lse=True``."""
    return torch.logsumexp(_scores(q, k, causal, window, scale), dim=-1)


def flash_attention_plain_bwd(q, k, v, dout, *, causal=True, window=0,
                              scale=None):
    """(dq, dk, dv): autograd through ``flash_attention_plain`` at ``dout``,
    the backward's plain version."""
    with torch.enable_grad():
        qq, kk, vv = (t.detach().requires_grad_(True) for t in (q, k, v))
        out = flash_attention_plain(qq, kk, vv, causal=causal, window=window,
                                    scale=scale)
        return torch.autograd.grad(out, (qq, kk, vv), dout)


def bwd_tolerance(q, k, v, dout, *, causal=True, window=0, scale=None):
    """How far K9's backward may lie from the exact gradient: for each of
    dq, dk, dv, twice the plain version's own largest error against its
    float64 evaluation on the same inputs (the plain version sums in f32
    and rounds once to the inputs' dtype). In bf16 the kernels' split bf16
    products leave about the same final rounding. In f32 it covers the
    TF32 kernels' three products to the product (hi.hi + hi.lo + lo.hi of
    operands split into two TF32 halves, about 2^-22 relative each; each k8
    slice summed on the tensor cores, the slices with FADD) as it covers the
    FFMA kernels: both stay near the plain version's own error, and one TF32
    product (2^-11) would lie hundreds of times outside. Returns (the
    float64 gradients, the three tolerances)."""
    kw = dict(causal=causal, window=window, scale=scale)
    plain = flash_attention_plain_bwd(q, k, v, dout, **kw)
    exact = flash_attention_plain_bwd(
        *(t.double() for t in (q, k, v, dout)), **kw)
    return exact, tuple(2.0 * float((p.double() - e).abs().max())
                        for p, e in zip(plain, exact))


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


def _check(q, k, v, name="flash_attention"):
    """Raise on operands K9 does not take; the kernel that takes them."""
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"{name}: q (B, Hq, S, D), k and v "
                         f"(B, Hkv, Skv, D)")
    b, hq, s, d = q.shape
    _, hkv, skv, dk = k.shape
    if k.shape[0] != b or dk != d or hkv == 0 or hq % hkv:
        raise ValueError(f"{name}: q {tuple(q.shape)} and k "
                         f"{tuple(k.shape)} do not agree (Hq must be a "
                         f"multiple of Hkv)")
    if q.dtype not in (torch.float32, torch.bfloat16) or \
            k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{name}: q, k, v must all be float32 or "
                        f"all bfloat16, got {q.dtype}, {k.dtype}, {v.dtype}")
    if d % 16 or not 16 <= d <= 256:
        raise ValueError(f"{name}: head dimension {d} is not a "
                         f"multiple of 16 in [16, 256]")
    if skv == 0:
        raise ValueError(f"{name}: no keys")
    return kernel_for(q.dtype, d)


def flash_attention_fwd(q, k, v, *, causal=True, window=0, scale=None,
                        return_lse=False):
    """Attention forward (K9); shapes and ``scale`` as
    ``flash_attention_plain``. A row
    with no valid key (only with a window, when q_pos >= Skv + window - 1)
    gets the plain version's answer, the mean of V over all keys. With
    ``return_lse`` also each row's logsumexp, (out, lse (B, Hq, S) float32),
    the backward's input."""
    if q.device.type != "cuda":
        out = flash_attention_plain(q, k, v, causal=causal, window=window,
                                    scale=scale)
        if not return_lse:
            return out
        return out, lse_plain(q, k, causal=causal, window=window,
                              scale=scale)
    kernel = _check(q, k, v)
    b, hq, s, d = q.shape
    _, hkv, skv, _ = k.shape
    qc, kc, vc = (t.contiguous() for t in (q, k, v))
    if kernel in ("wgmma_bf16", "wgmma_tf32x3"):
        qc, kc, vc = _aligned(qc, kc, vc)
    out = torch.empty_like(qc)
    lse = torch.empty((b, hq, s), dtype=torch.float32, device=q.device) \
        if return_lse else None
    _build.require_cuda("flash_attention", qc, kc, vc, out)
    lib = _build.library()
    ptrs = (qc.data_ptr(), kc.data_ptr(), vc.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr())
    dims = (b, hq, hkv, s, skv, d, int(bool(causal)), _window(window, s),
            1.0 / math.sqrt(d) if scale is None else float(scale))
    if kernel == "wgmma_bf16":
        rc = lib.repro_flash_attention_wgmma(*ptrs, *dims, _build.stream())
    elif kernel == "wgmma_tf32x3":
        # the pre-pass's hi and lo halves: k as it is, v transposed (the
        # kernel splits q itself)
        ks, vt = _tf32_scratch(q.device, (2, b, hkv, skv, d),
                               (2, b, hkv, d, _pad8(skv)))
        rc = lib.repro_flash_attention_tf32x3(
            *ptrs, ks.data_ptr(), vt.data_ptr(), *dims, _build.stream())
    else:
        rc = lib.repro_flash_attention(
            *ptrs, *dims, int(q.dtype == torch.bfloat16), _build.stream())
    _build.check(rc, "flash_attention")
    launches.add(launches_per_call(q.dtype, d))
    return (out, lse) if return_lse else out


def flash_attention_bwd(q, k, v, lse, dout, *, causal=True, window=0,
                        scale=None):
    """K9's backward: (dq, dk, dv) like (q, k, v), from the forward's
    ``lse`` (``return_lse=True``) and the output's gradient ``dout``;
    shapes and ``scale`` as ``flash_attention_plain``. On a CUDA tensor it
    launches the kernels ``bwd_kernel_for`` names or raises (what the
    forward refuses, and a window that leaves a row with no valid key); on
    a CPU tensor it runs ``flash_attention_plain_bwd``."""
    if q.device.type != "cuda":
        return flash_attention_plain_bwd(q, k, v, dout, causal=causal,
                                         window=window, scale=scale)
    kernel = _check(q, k, v, "flash_attention_bwd")   # = bwd_kernel_for
    b, hq, s, d = q.shape
    _, hkv, skv, _ = k.shape
    w = _window(window, s)
    if w and s >= skv + w:
        raise ValueError(f"flash_attention_bwd: window {w} leaves rows "
                         f"{skv + w - 1}.. of {s} with no valid key")
    if dout.shape != q.shape or dout.dtype != q.dtype:
        raise ValueError(f"flash_attention_bwd: dout {tuple(dout.shape)} "
                         f"{dout.dtype} is not like q {tuple(q.shape)} "
                         f"{q.dtype}")
    if lse.shape != (b, hq, s) or lse.dtype != torch.float32:
        raise ValueError(f"flash_attention_bwd: lse must be ({b}, {hq}, "
                         f"{s}) float32, got {tuple(lse.shape)} {lse.dtype}")
    qc, kc, vc, lc, oc = (t.contiguous() for t in (q, k, v, lse, dout))
    if kernel in ("wgmma_bf16", "wgmma_tf32x3"):
        qc, kc, vc, oc = _aligned(qc, kc, vc, oc)
    dq, dk, dv = (torch.empty_like(t) for t in (qc, kc, vc))
    dsum = torch.empty_like(lc)
    _build.require_cuda("flash_attention_bwd", qc, kc, vc, lc, oc, dq, dk,
                        dv, dsum)
    lib = _build.library()
    ptrs = (qc.data_ptr(), kc.data_ptr(), vc.data_ptr(), oc.data_ptr(),
            lc.data_ptr(), dsum.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr())
    dims = (b, hq, hkv, s, skv, d, int(bool(causal)), w,
            1.0 / math.sqrt(d) if scale is None else float(scale))
    # wgmma and TF32: each q head's dK and dV in f32 when Hq > Hkv, summed
    # over the group after
    part = torch.empty((2, b, hq, skv, d), dtype=torch.float32,
                       device=q.device) \
        if kernel in ("wgmma_bf16", "wgmma_tf32x3") and hq > hkv else None
    part_ptr = None if part is None else part.data_ptr()
    if kernel == "wgmma_bf16":
        rc = lib.repro_flash_attention_bwd_wgmma(*ptrs, part_ptr, *dims,
                                                 _build.stream())
    elif kernel == "wgmma_tf32x3":
        # the pre-pass's hi and lo halves: q, dout, k, v as they are; k, q
        # and dout transposed
        halves = _tf32_scratch(
            q.device, (2, b, hq, s, d), (2, b, hq, s, d), (2, b, hkv, skv, d),
            (2, b, hkv, skv, d), (2, b, hkv, d, _pad8(skv)),
            (2, b, hq, d, _pad8(s)), (2, b, hq, d, _pad8(s)))
        rc = lib.repro_flash_attention_bwd_tf32x3(
            *ptrs, part_ptr, *(h.data_ptr() for h in halves), *dims,
            _build.stream())
    else:
        rc = lib.repro_flash_attention_bwd(
            *ptrs, *dims, int(q.dtype == torch.bfloat16), _build.stream())
    _build.check(rc, "flash_attention_bwd")
    bwd_launches.add(bwd_launches_per_call(q.dtype, d, hq // hkv))
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """K9 with its gradient: the forward saves its logsumexp, the backward
    is ``flash_attention_bwd``. CUDA tensors only (the CPU's autograd runs
    through the plain versions)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale):
        out, lse = flash_attention_fwd(q, k, v, causal=causal, window=window,
                                       scale=scale, return_lse=True)
        ctx.save_for_backward(q, k, v, lse)
        ctx.mask = (causal, window, scale)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, lse = ctx.saved_tensors
        causal, window, scale = ctx.mask
        dq, dk, dv = flash_attention_bwd(q, k, v, lse, dout, causal=causal,
                                         window=window, scale=scale)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, *, causal=True, window=0, scale=None):
    """K9 forward, differentiable: through ``FlashAttention`` when a CUDA
    operand wants a gradient, else ``flash_attention_fwd``."""
    if q.device.type == "cuda" and torch.is_grad_enabled() and any(
            t.requires_grad for t in (q, k, v)):
        return FlashAttention.apply(q, k, v, causal, window, scale)
    return flash_attention_fwd(q, k, v, causal=causal, window=window,
                               scale=scale)
