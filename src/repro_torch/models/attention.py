"""Attention: the prefill's causal / local GQA attention and single-position
decode attention against a KV cache or ring.

The port of the JAX package's ``repro/models/attention.py``. In JAX,
``chunked_attention`` is plain jnp (an online softmax over (q_chunk x
kv_chunk) tiles), and the Pallas flash kernel is "the TPU-optimized version
of the same math". Here the lowering is chosen explicitly
(``impl``, the config's ``attention_impl``):

- ``fused``: on a CUDA tensor it launches K9
  (``kernels/flash_attention.py::flash_attention_fwd``), and raises on what
  K9 does not take (a logit softcap, explicit positions: K9 takes only the
  top-left ``arange`` positions the prefill passes as ``None``; a head
  dimension outside its range); it never quietly runs the plain version.
  On a CPU tensor it runs the plain mirror below.
- ``reference``: the plain mirror of the JAX function on any device: the
  same chunk sizes (``_fit``: 1500 -> 750), the same online softmax, p cast
  to v's dtype before P V.

Both pre-scale q by 1/sqrt(D) in float32 and round it back to q's dtype, as
JAX does; K9 then takes ``scale=1.0``, so it computes what the JAX module
computes. ``decode_attention`` is plain torch on every device: the JAX
package has no kernel for it. ``combine_partial`` (the split-KV psum
combine) needs a collective and waits for the sharded slice (ROADMAP
Queue 1 item 14f).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import flash_attention as fa

NEG_INF = -1e30
F32 = torch.float32


def _split_heads(q, num_kv_heads):
    """(B, Hq, S, D) -> (B, Hkv, G, S, D) for GQA."""
    b, hq, s, d = q.shape
    return q.reshape(b, num_kv_heads, hq // num_kv_heads, s, d)


def _softcap(s, cap: float):
    if cap and cap > 0.0:
        return torch.tanh(s / cap) * cap
    return s


def _mask_bias(q_pos, kv_pos, causal: bool, window: int):
    """(Sq, Skv) additive bias from position vectors."""
    ok = torch.ones((q_pos.shape[0], kv_pos.shape[0]), dtype=torch.bool,
                    device=q_pos.device)
    if causal:
        ok &= kv_pos[None, :] <= q_pos[:, None]
    if window and window > 0:
        ok &= q_pos[:, None] - kv_pos[None, :] < window
    return torch.where(ok, 0.0, NEG_INF)


def _fit(s, c):
    """The largest chunk <= c that divides s (1500 -> 750, ...)."""
    c = min(c, s)
    while s % c:
        c -= 1
    return c


def prescale(q):
    """q * D**-0.5 in float32, rounded back to q's dtype (JAX's
    ``chunked_attention`` and ``decode_attention`` do so before Q K^T)."""
    return (q.to(F32) * q.shape[-1] ** -0.5).to(q.dtype)


def chunked_attention(q, k, v, *, causal=True, window=0, q_positions=None,
                      kv_positions=None, q_chunk=1024, kv_chunk=1024,
                      softcap=0.0, impl="fused"):
    """q: (B, Hq, Sq, D); k, v: (B, Hkv, Skv, D) -> (B, Hq, Sq, D) in q's
    dtype. Positions default to ``arange``; see the module docstring for
    ``impl``."""
    if impl not in ("fused", "reference"):
        raise ValueError(f"attention impl must be 'fused' or 'reference', "
                         f"got {impl!r}")
    if impl == "fused" and q.device.type == "cuda":
        if softcap and softcap > 0.0:
            raise NotImplementedError(
                "chunked_attention: K9 takes no logit softcap; no config "
                "sets one (use attention_impl='reference')")
        if q_positions is not None or kv_positions is not None:
            raise NotImplementedError(
                "chunked_attention: K9 takes only the top-left arange "
                "positions, passed as None")
        return fa.flash_attention_fwd(prescale(q), k, v, causal=causal,
                                      window=window, scale=1.0)
    return _chunked_plain(q, k, v, causal, window, q_positions,
                          kv_positions, q_chunk, kv_chunk, softcap)


def _chunked_plain(q, k, v, causal, window, q_positions, kv_positions,
                   q_chunk, kv_chunk, softcap):
    b, hq, sq, d = q.shape
    _, hkv, skv, _ = k.shape
    dev = q.device
    if q_positions is None:
        q_positions = torch.arange(sq, device=dev)
    if kv_positions is None:
        kv_positions = torch.arange(skv, device=dev)
    q_chunk = _fit(sq, q_chunk)
    kv_chunk = _fit(skv, kv_chunk)
    nq, nk = sq // q_chunk, skv // kv_chunk

    qg = prescale(_split_heads(q, hkv))            # (B,Hkv,G,Sq,D)
    g = qg.shape[2]
    outs = []
    for i in range(nq):
        qs = slice(i * q_chunk, (i + 1) * q_chunk)
        qi = qg[:, :, :, qs].to(F32)               # exact products in f32
        qp = q_positions[qs]
        m = torch.full((b, hkv, g, q_chunk), NEG_INF, dtype=F32, device=dev)
        l = torch.zeros((b, hkv, g, q_chunk), dtype=F32, device=dev)
        acc = torch.zeros((b, hkv, g, q_chunk, d), dtype=F32, device=dev)
        for j in range(nk):
            ks = slice(j * kv_chunk, (j + 1) * kv_chunk)
            vi = v[:, :, ks]
            s = torch.einsum("bhgqd,bhkd->bhgqk", qi, k[:, :, ks].to(F32))
            s = _softcap(s, softcap)
            s = s + _mask_bias(qp, kv_positions[ks], causal, window)
            m_new = torch.maximum(m, torch.amax(s, dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + torch.sum(p, dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bhgqk,bhkd->bhgqd", p.to(vi.dtype).to(F32), vi.to(F32))
            m = m_new
        out = acc / torch.clamp_min(l, 1e-30)[..., None]
        outs.append(out.to(q.dtype))               # (B,Hkv,G,qc,D)
    return torch.cat(outs, dim=3).reshape(b, hq, sq, d)


def decode_attention(q, k, v, kv_positions, cache_len, *, window=0,
                     softcap=0.0):
    """Single-position attention against a (possibly partial/ring) KV cache.

    q: (B, Hq, D); k, v: (B, Hkv, S, D); kv_positions: (S,) global position
    of each cache slot (-1 = never written); cache_len: 0-d integer tensor
    (= current position + 1), read on the device. Returns (out (B,Hq,D)
    unnormalised, m (B,Hq), l (B,Hq)), the partial-softmax statistics."""
    b, hq, d = q.shape
    _, hkv, s, _ = k.shape
    qg = prescale(q.reshape(b, hkv, hq // hkv, d))
    s_ = torch.einsum("bhgd,bhkd->bhgk", qg.to(F32), k.to(F32))
    s_ = _softcap(s_, softcap)
    ok = (kv_positions < cache_len) & (kv_positions >= 0)
    if window and window > 0:
        ok &= kv_positions > cache_len - 1 - window
    s_ = torch.where(ok[None, None, None, :], s_, NEG_INF)
    m = torch.amax(s_, dim=-1)
    p = torch.exp(s_ - m[..., None])
    l = torch.sum(p, dim=-1)
    out = torch.einsum("bhgk,bhkd->bhgd", p.to(v.dtype).to(F32), v.to(F32))
    return out.reshape(b, hq, d), m.reshape(b, hq), l.reshape(b, hq)


def finalize_partial(out, m, l):
    """Single-shard finalize (no combine)."""
    del m
    return out / torch.clamp_min(l, 1e-30)[..., None]
