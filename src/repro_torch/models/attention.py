"""Attention: the prefill's causal / local GQA attention and single-position
decode attention against a KV cache or ring.

The port of the JAX package's ``repro/models/attention.py``. In JAX,
``chunked_attention`` is plain jnp (an online softmax over (q_chunk x
kv_chunk) tiles), and the Pallas flash kernel is "the TPU-optimized version
of the same math". Here the lowering is chosen explicitly
(``impl``, the config's ``attention_impl``):

- ``fused``: on a CUDA tensor it launches K9
  (``kernels/flash_attention.py::flash_attention``: the forward alone, or,
  when a gradient is wanted, ``FlashAttention``, whose backward is K9's
  backward kernel), and raises on what
  K9 does not take (a logit softcap, explicit positions: K9 takes only the
  top-left ``arange`` positions the prefill passes as ``None``; a head
  dimension outside its range); it never quietly runs the plain version.
  On a CPU tensor it runs the plain mirror below.
- ``reference``: the plain mirror of the JAX function on any device: the
  same chunk sizes (``_fit``: 1500 -> 750), the same online softmax, p cast
  to v's dtype before P V. On ``meta`` (the dry run, which computes no
  value) it traces one row of one tile, counted as all of them
  (``dist.repeated``): every tile has the same shapes.

Both pre-scale q by 1/sqrt(D) in float32 and round it back to q's dtype, as
JAX does; K9 then takes ``scale=1.0``, so it computes what the JAX module
computes. ``decode_attention`` is plain torch on every device: the JAX
package has no kernel for it. ``combine_partial`` merges split-KV partials
across a mesh axis (``pmax`` and two ``psum``s of a rank's
``dist.MeshComm``).
"""
from __future__ import annotations

import torch

from repro_torch.dist import repeated
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
        return fa.flash_attention(prescale(q), k, v, causal=causal,
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
    meta = dev.type == "meta"

    def tile(qi, qp, kj, vj, kp, m, l, acc):
        s = torch.einsum("bhgqd,bhkd->bhgqk", qi, kj.to(F32))
        s = _softcap(s, softcap)
        s = s + _mask_bias(qp, kp, causal, window)
        m_new = torch.maximum(m, torch.amax(s, dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + torch.sum(p, dim=-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bhgqk,bhkd->bhgqd", p.to(vj.dtype).to(F32), vj.to(F32))
        return m_new, l, acc

    def row(qi, qp, k, v):
        qi = qi.to(F32)                            # exact products in f32
        g = qi.shape[2]
        m = torch.full((b, hkv, g, q_chunk), NEG_INF, dtype=F32, device=dev)
        l = torch.zeros((b, hkv, g, q_chunk), dtype=F32, device=dev)
        acc = torch.zeros((b, hkv, g, q_chunk, d), dtype=F32, device=dev)
        if meta:         # the dry run: one tile counted as the row's nk
            m, l, acc = repeated(nk, tile, qi, qp, k[:, :, :kv_chunk],
                                 v[:, :, :kv_chunk], kv_positions[:kv_chunk],
                                 m, l, acc)
        else:
            for j in range(nk):
                ks = slice(j * kv_chunk, (j + 1) * kv_chunk)
                m, l, acc = tile(qi, qp, k[:, :, ks], v[:, :, ks],
                                 kv_positions[ks], m, l, acc)
        out = acc / torch.clamp_min(l, 1e-30)[..., None]
        return out.to(q.dtype)                     # (B,Hkv,G,qc,D)

    qg = prescale(_split_heads(q, hkv))            # (B,Hkv,G,Sq,D)
    if meta:             # the dry run: one row counted as the nq rows
        outs = [repeated(nq, row, qg[:, :, :, :q_chunk],
                         q_positions[:q_chunk], k, v)] * nq
    else:
        outs = [row(qg[:, :, :, i * q_chunk:(i + 1) * q_chunk],
                    q_positions[i * q_chunk:(i + 1) * q_chunk], k, v)
                for i in range(nq)]
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


def combine_partial(out, m, l, axis_name, mesh=None):
    """Combine split-KV partial attention (out = unnormalized p@v, m, l)
    across ``axis_name`` of ``mesh`` (a rank's ``dist.MeshComm``; the
    context's, ``sharding.use_mesh``, when None) with a numerically-stable
    softmax merge. Only (o, m, l) crosses the link, never the KV cache."""
    if mesh is None:
        from repro_torch.parallel import sharding as shd
        mesh = shd.current_mesh()
    m_g = mesh.pmax(m, axis_name)
    w = torch.exp(m - m_g)
    # the two sums in one psum
    both = mesh.psum(torch.cat([out * w[..., None], (l * w)[..., None]], -1),
                     axis_name)
    out, l = both[..., :-1], both[..., -1]
    return out / torch.clamp_min(l, 1e-30)[..., None]


def finalize_partial(out, m, l):
    """Single-shard finalize (no combine)."""
    del m
    return out / torch.clamp_min(l, 1e-30)[..., None]
