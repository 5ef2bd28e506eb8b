"""K9's plain version (``repro_torch.kernels.ops.flash_attention`` on CPU
tensors) against the JAX package's Pallas flash attention
(``repro.kernels.ops.flash_attention`` with ``interpret=True``), from the
same numpy inputs: the ``test_flash_attention_causal`` grid of
``tests/test_kernels.py`` in f32 and bf16, windows 32 and 128, a head
dimension of 192, and Skv != S.

Tolerance: the JAX kernel tests' own, 2e-5 in f32 and 2e-2 in bf16,
compared in f32. The port's plain version is the full softmax of
``kernels/ref.py``; the JAX kernel runs an online softmax over 128-key
tiles and, in bf16, rounds p to bf16 before P V. A bf16 input is the same
round-to-nearest-even of the numpy f32 values on both sides. In bf16 each
element of the JAX kernel's output is also held within
``flash_attention.bf16_error_bound`` of the port's plain version, the
bound the card tests hold the CUDA kernel to. A test holds the bound
itself: a torch emulation of the bf16 kernel's arithmetic lies within it,
and the same emulation with a dropped or mis-scaled tile does not. The last
test holds the f32 TF32 kernels' arithmetic (each f32 product as three TF32
products) against the tolerances the card tests hold them to, 2e-5 for the
forward and ``flash_attention.bwd_tolerance`` for the backward, and one
TF32 product outside both.
"""
import functools
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops, ref

DTYPES = {"f32": (jnp.float32, torch.float32, 2e-5),
          "bf16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _case(b, hq, hkv, s, skv, d, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, hq, s, d)).astype(np.float32),
            rng.normal(size=(b, hkv, skv, d)).astype(np.float32),
            rng.normal(size=(b, hkv, skv, d)).astype(np.float32))


def _compare(arrays, dtype, causal=True, window=0):
    jdt, tdt, tol = DTYPES[dtype]
    jq, jk, jv = (jnp.asarray(a).astype(jdt) for a in arrays)
    tq, tk, tv = (torch.from_numpy(a).to(tdt) for a in arrays)
    jo = jops.flash_attention(jq, jk, jv, causal=causal, window=window,
                              interpret=True)
    to = ops.flash_attention(tq, tk, tv, causal=causal, window=window)
    assert to.dtype == tdt and tuple(to.shape) == tuple(jo.shape)
    np.testing.assert_allclose(to.float().numpy(),
                               np.asarray(jo.astype(jnp.float32)),
                               rtol=tol, atol=tol)
    if dtype == "bf16":
        lim = fa.bf16_error_bound(to, tq, tk, tv, causal=causal,
                                  window=window)
        diff = (torch.from_numpy(np.array(jo.astype(jnp.float32)))
                - to.float()).abs()
        assert bool((diff <= lim).all())
    jr = jref.attention_ref(jq, jk, jv, causal=causal, window=window)
    np.testing.assert_allclose(
        ref.attention_ref(tq, tk, tv, causal=causal,
                          window=window).float().numpy(),
        np.asarray(jr.astype(jnp.float32)), rtol=tol, atol=tol)


@pytest.mark.parametrize("b,hq,hkv,s,d", [
    (1, 2, 2, 128, 64),    # MHA
    (2, 4, 2, 256, 64),    # GQA 2:1
    (1, 8, 1, 256, 128),   # MQA
    (1, 2, 1, 384, 32),    # S not a multiple of 256
])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_flash_attention_causal(b, hq, hkv, s, d, dtype):
    _compare(_case(b, hq, hkv, s, s, d, seed=s + d), dtype)


@pytest.mark.parametrize("window", [32, 128])
def test_flash_attention_local_window(window):
    _compare(_case(1, 2, 1, 256, 256, 64, seed=window), "f32", window=window)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_flash_attention_head_dim_192(dtype):
    _compare(_case(1, 2, 1, 128, 128, 192, seed=192), dtype)


def test_flash_attention_more_keys_than_queries():
    """Skv != S with top-left positions: query q sees keys 0..q."""
    _compare(_case(1, 4, 2, 128, 256, 64, seed=7), "f32")


def test_rows_without_a_valid_key_follow_the_oracle():
    """S=256, Skv=64, window 32, f32: query rows q >= Skv + window - 1 = 95
    see no key. The port follows ``ref.attention_ref`` on every row (the
    mean of V over all keys where none is valid). The JAX kernel equals the
    port on every row that sees a key, and differs only on rows that see
    none: there its value depends on its tile skipping (a q tile whose kv
    tiles were all skipped keeps its zero accumulator; a q tile with a
    live kv tile takes the mean of V over that tile), which is why the
    port takes the oracle's value instead."""
    s, skv, window = 256, 64, 32
    arrays = _case(1, 2, 1, s, skv, 64, seed=95)
    jq, jk, jv = (jnp.asarray(a) for a in arrays)
    tq, tk, tv = (torch.from_numpy(a) for a in arrays)
    jo = np.asarray(jops.flash_attention(jq, jk, jv, causal=True,
                                         window=window, interpret=True))
    to = ops.flash_attention(tq, tk, tv, causal=True, window=window).numpy()
    oracle = ref.attention_ref(tq, tk, tv, causal=True,
                               window=window).numpy()
    np.testing.assert_allclose(to, oracle, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(
        to, np.asarray(jref.attention_ref(jq, jk, jv, causal=True,
                                          window=window)),
        rtol=2e-5, atol=2e-5)
    q = np.arange(s)
    seen = q < skv + window - 1        # rows with at least one valid key
    np.testing.assert_allclose(to[:, :, seen], jo[:, :, seen], rtol=2e-5,
                               atol=2e-5)
    differ = (np.abs(to - jo) > 2e-5).any(axis=(0, 1, 3))
    assert differ.any() and not (differ & seen).any()
    assert (jo[:, :, differ] == 0).all()   # the skipped tiles' zero rows


FAULT_KEY = 1280    # a fault late in rows of 1,536 keys
LOG2E = 1.4426950408889634


def fault_tile(tile):
    """The tile that holds keys 1,280 on (of 1,536)."""
    return FAULT_KEY // tile


def _online_bf16(q, k, v, window, *, kernel, drop=None, scale=1.0, tile=128):
    """A bf16 kernel's arithmetic in torch: an online softmax over
    ``tile``-key tiles, p rounded to bf16 before P V, f32 accumulators.
    ``kernel`` picks the exponent: ``"mma_sync_bf16"`` scales the scores
    and takes exp(s - m); ``"wgmma_bf16"`` keeps raw scores and takes
    exp2(s c - m c) with the scale folded into c = log2(e) / sqrt(D) (one
    fused multiply-add), a row whose keys so far are all masked taking 1
    per masked key. ``drop`` skips one tile and ``scale`` multiplies the p
    of tile ``fault_tile(tile)``: faults late in long rows."""
    s_q, d = q.shape[2], q.shape[3]
    fma = kernel == "wgmma_bf16"
    c = torch.tensor((1.0 / d ** 0.5) * LOG2E, dtype=torch.float32)
    kf = torch.repeat_interleave(k, q.shape[1] // k.shape[1], 1).float()
    vf = torch.repeat_interleave(v, q.shape[1] // v.shape[1], 1).float()
    m = torch.full((*q.shape[:3], 1), fa.NEG)
    l = torch.zeros_like(m)
    acc = torch.zeros(q.shape)
    qpos = torch.arange(s_q)[:, None]
    for t0 in range(0, k.shape[2], tile):
        if t0 // tile == drop:
            continue
        kpos = torch.arange(t0, min(t0 + tile, k.shape[2]))[None, :]
        ok = (kpos <= qpos) & ((qpos - kpos < window) if window else True)
        sc = q.float() @ kf[:, :, t0:t0 + tile].transpose(-1, -2)
        if not fma:
            sc = sc / d ** 0.5
        sc = torch.where(ok, sc, torch.tensor(fa.NEG))
        m_new = torch.maximum(m, sc.amax(-1, keepdim=True))
        if fma:
            corr = torch.exp2((m - m_new) * c)
            p = torch.exp2(torch.addcmul(-m_new * c, sc, c))
            # exp(NEG - NEG) = 1, as the plain softmax of NEG scores gives
            # (the fused multiply-add would leave NEG c's rounding error)
            p = torch.where(m_new == fa.NEG, (sc == fa.NEG).float(), p)
        else:
            corr = torch.exp(m - m_new)
            p = torch.exp(sc - m_new)
        p = p * (scale if t0 // tile == fault_tile(tile) else 1.0)
        l = l * corr + p.sum(-1, keepdim=True)
        acc = acc * corr + p.to(torch.bfloat16).float() @ vf[:, :, t0:t0 + tile]
        m = m_new
    return (acc / l.clamp_min(1e-30)).to(torch.bfloat16)


@pytest.mark.parametrize("kernel,tile", [
    ("mma_sync_bf16", 64), ("wgmma_bf16", 64), ("wgmma_bf16", 128)])
@pytest.mark.parametrize("window", [0, 512])
def test_bf16_error_bound_admits_rounding_and_flags_faults(window, kernel,
                                                           tile):
    """At 1,536 keys the bound admits each bf16 kernel's roundings (mma.sync
    over 64-key tiles; wgmma over 128-key tiles, 64 at D 256) with room to
    spare, and flags a dropped tile or one tile's p 5 % off."""
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16)
               for a in _case(1, 2, 1, 1536, 1536, 64, seed=3))
    plain = fa.flash_attention_plain(q, k, v, causal=True, window=window)
    lim = fa.bf16_error_bound(plain, q, k, v, causal=True, window=window)
    run = functools.partial(_online_bf16, q, k, v, window, kernel=kernel,
                            tile=tile)

    def over(out):
        return float(((out.float() - plain.float()).abs() / lim).max())

    assert over(run()) < 0.8
    assert over(run(drop=fault_tile(tile))) > 2.0
    assert over(run(scale=1.05)) > 2.0


@pytest.mark.parametrize("d,dtype,kernel", [
    (64, torch.bfloat16, "wgmma_bf16"), (128, torch.bfloat16, "wgmma_bf16"),
    (256, torch.bfloat16, "wgmma_bf16"),
    (192, torch.bfloat16, "mma_sync_bf16"),
    (48, torch.bfloat16, "mma_sync_bf16"),
    (64, torch.float32, "wgmma_tf32x3"), (128, torch.float32, "wgmma_tf32x3"),
    (256, torch.float32, "ffma_f32"), (48, torch.float32, "ffma_f32")])
def test_kernel_choice_depends_on_dtype_and_head_dim_only(d, dtype, kernel):
    """The wrapper picks the card's kernel from the dtype and D alone, so a
    shape's kernel is the same on every call (on TF32 after its pre-pass,
    ``split_tf32``), and a CPU tensor launches none of them."""
    assert fa.kernel_for(dtype, d) == kernel
    want = {kernel: 1, "split_tf32": int(kernel == "wgmma_tf32x3")}
    assert fa.kernel_launches(dtype, d) == {
        name: want.get(name, 0) for name in fa.KERNELS}
    assert fa.launches_per_call(dtype, d) == sum(want.values())
    before = fa.launches.count
    q = torch.zeros(1, 2, 8, d, dtype=dtype)
    ops.flash_attention(q, q, q)
    assert fa.launches.count == before


@pytest.mark.parametrize("d,dtype,group,kernel,per_call", [
    (64, torch.bfloat16, 1, "wgmma_bf16",
     {"dq_wgmma": 1, "dkdv_wgmma": 1}),
    (128, torch.bfloat16, 7, "wgmma_bf16",
     {"dq_wgmma": 1, "dkdv_wgmma": 1, "group_sum": 1}),
    (256, torch.bfloat16, 1, "wgmma_bf16",
     {"dq_wgmma": 1, "dkdv_wgmma": 1}),
    (256, torch.bfloat16, 10, "wgmma_bf16",
     {"dq_wgmma": 1, "dkdv_wgmma": 1, "group_sum": 1}),
    (96, torch.bfloat16, 4, "mma_sync_bf16", {"dq_bf16": 1, "dkdv_bf16": 1}),
    (192, torch.bfloat16, 1, "mma_sync_bf16",
     {"dq_bf16": 1, "dkdv_bf16": 2}),
    (64, torch.float32, 1, "wgmma_tf32x3",
     {"split_tf32": 1, "dq_tf32x3": 1, "dkdv_tf32x3": 1}),
    (128, torch.float32, 7, "wgmma_tf32x3",
     {"split_tf32": 1, "dq_tf32x3": 1, "dkdv_tf32x3": 1,
      "group_sum_f32": 1}),
    (48, torch.float32, 4, "ffma_f32", {"dq_f32": 1, "dkdv_f32": 1}),
    (256, torch.float32, 1, "ffma_f32", {"dq_f32": 1, "dkdv_f32": 1})])
def test_bwd_kernel_choice_depends_on_dtype_head_dim_and_group_only(
        d, dtype, group, kernel, per_call):
    """The backward's kernels, and each one's launches a call, follow from
    the dtype, D and the group size alone (the group sum only on wgmma with
    Hq > Hkv; on TF32 the pre-pass first), and a CPU tensor launches none
    of them."""
    assert fa.bwd_kernel_for(dtype, d) == kernel
    want = {name: per_call.get(name, 0) for name in fa.BWD_KERNELS}
    assert fa.bwd_kernel_launches(dtype, d, group) == want
    assert fa.bwd_launches_per_call(dtype, d, group) == sum(want.values())
    before = fa.bwd_launches.count
    q = torch.zeros(1, group, 8, d, dtype=dtype)
    k = torch.zeros(1, 1, 8, d, dtype=dtype)
    lse = fa.lse_plain(q, k)
    fa.flash_attention_bwd(q, k, k, lse, q)
    assert fa.bwd_launches.count == before


def _tf32(x):
    """x rounded to TF32 as ``cvt.rna.tf32.f32`` rounds it: to nearest, ties
    away from zero, the low 13 mantissa bits cleared (adding half their
    unit to the sign-magnitude bits carries into the kept ones)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _mm_tf32(a, b, terms):
    """a @ b in f32 as the TF32 kernels take it: with ``terms`` 3, each
    operand split into hi = tf32(x) and lo = tf32(x - hi) and the product
    the f32 sum of lo.hi + hi.lo, then hi.hi (TF32 products are exact in
    f32); with ``terms`` 1, hi.hi alone."""
    ah, bh = _tf32(a), _tf32(b)
    if terms == 1:
        return ah @ bh
    al, bl = _tf32(a - ah), _tf32(b - bh)
    return (al @ bh + ah @ bl) + ah @ bh


def _attention_tf32(q, k, v, do, causal, window, terms):
    """The plain attention forward and its backward with every matrix
    product through ``_mm_tf32``: (out, (dq, dk, dv))."""
    b, hq, s, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    g = hq // hkv
    kr, vr = (torch.repeat_interleave(x, g, 1) for x in (k, v))
    scale = 1.0 / math.sqrt(d)
    sc = _mm_tf32(q, kr.transpose(-1, -2), terms) * scale
    qpos, kpos = torch.arange(s)[:, None], torch.arange(skv)[None, :]
    ok = torch.ones(s, skv, dtype=torch.bool)
    if causal:
        ok &= kpos <= qpos
    if window:
        ok &= qpos - kpos < window
    p = torch.softmax(torch.where(ok, sc, torch.tensor(fa.NEG)), -1)
    out = _mm_tf32(p, vr, terms)
    dp = _mm_tf32(do, vr.transpose(-1, -2), terms)
    ds = p * (dp - (p * dp).sum(-1, keepdim=True))
    dq = _mm_tf32(ds, kr, terms) * scale
    dk = (_mm_tf32(ds.transpose(-1, -2), q, terms) * scale).view(
        b, hkv, g, skv, d).sum(2)
    dv = _mm_tf32(p.transpose(-1, -2), do, terms).view(
        b, hkv, g, skv, d).sum(2)
    return out, (dq, dk, dv)


@pytest.mark.parametrize("terms", [3, 1])
@pytest.mark.parametrize("shape,causal,window", [
    ((1, 4, 2, 128, 128, 64), True, 0), ((1, 4, 2, 160, 160, 64), True, 48),
    ((2, 2, 1, 64, 96, 32), False, 0)])
def test_tf32x3_arithmetic_meets_the_f32_tolerances(shape, causal, window,
                                                    terms):
    """Three TF32 products to the product, in the plain attention forward
    and backward: the output within 2e-5 (absolute + relative) of
    ``flash_attention_plain``, dq, dk, dv within ``bwd_tolerance`` of the
    float64 gradient. One TF32 product lies outside every one of them (some
    1,000 times its tolerance), which shows that the check can fail."""
    b, hq, hkv, s, skv, d = shape
    rng = np.random.default_rng(s + skv + d)
    q, do = (torch.from_numpy(rng.normal(size=(b, hq, s, d)).astype(
        np.float32)) for _ in range(2))
    k, v = (torch.from_numpy(rng.normal(size=(b, hkv, skv, d)).astype(
        np.float32)) for _ in range(2))
    out, grads = _attention_tf32(q, k, v, do, causal, window, terms)
    plain = fa.flash_attention_plain(q, k, v, causal=causal, window=window)
    fwd = float(((out - plain).abs() / (2e-5 + 2e-5 * plain.abs())).max())
    exact, tol = fa.bwd_tolerance(q, k, v, do, causal=causal, window=window)
    bwd = [float((x.double() - e).abs().max()) / t
           for x, e, t in zip(grads, exact, tol)]
    if terms == 3:
        assert fwd <= 1.0 and max(bwd) <= 1.0, (fwd, bwd)
    else:
        assert fwd > 10.0 and min(bwd) > 10.0, (fwd, bwd)
