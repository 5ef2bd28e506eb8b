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
bound the card tests hold the CUDA kernel to. The last test holds the
bound itself: a torch emulation of the bf16 kernel's arithmetic lies within
it, and the same emulation with a dropped or mis-scaled tile does not.
"""
import functools

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
    (128, torch.float32, "ffma_f32"), (256, torch.float32, "ffma_f32")])
def test_kernel_choice_depends_on_dtype_and_head_dim_only(d, dtype, kernel):
    """The wrapper picks the card's kernel from the dtype and D alone, so a
    shape's kernel is the same on every call, and a CPU tensor launches
    none of them."""
    assert fa.kernel_for(dtype, d) == kernel
    before = fa.launches.count
    q = torch.zeros(1, 2, 8, d, dtype=dtype)
    ops.flash_attention(q, q, q)
    assert fa.launches.count == before
