"""The LM stack's building blocks (``repro_torch.models.layers``,
``attention``, ``rglru``) against the JAX package's, from the same numpy
inputs made from a seed.

Tolerances: float32 inputs, 1e-5 (the blocks are the same float32
arithmetic; sums run in another order). The bf16 cases hold each element
within 2 bf16 ulps of the larger output (2**-7 relative): both sides round
the same f32 results to bf16, and a sum taken in another order can land
one ulp apart before the last rounding. The prefill attention on the CPU
is the plain chunked mirror under either lowering (``impl='fused'`` runs K9
only on a CUDA tensor): it is held against JAX's ``chunked_attention`` at
chunk sizes that split the sequence, so the online softmax's carry across
chunks is compared too. K9's ``scale`` keyword is held on a pre-scaled q.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jget
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import rglru as jrglru
from repro.models import decode as jdecode
from repro_torch.configs import get_smoke_config as tget
from repro_torch.kernels import flash_attention as fa
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers
from repro_torch.models import rglru as trglru
from repro_torch import convert

F32_TOL = 1e-5


def _both(a, dtype="float32"):
    """One numpy array as a JAX and a torch array of ``dtype``."""
    return (jnp.asarray(a).astype(dtype),
            torch.from_numpy(np.asarray(a, np.float32)).to(
                getattr(torch, dtype)))


def _close(t, j, dtype="float32", tol=F32_TOL):
    got = t.float().numpy()
    want = np.asarray(jnp.asarray(j).astype(jnp.float32))
    if dtype == "bfloat16":
        tol = 2 ** -7 * max(np.abs(want).max(), 1e-30)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


def _params(jp):
    return convert.lm_params_from_numpy(jax.device_get(jp), device="cpu")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["rms", "layer"])
def test_norms(kind, dtype):
    rng = np.random.default_rng(1)
    x = rng.normal(2.0, 3.0, size=(3, 5, 48)).astype(np.float32)
    p = {"scale": rng.normal(size=48).astype(np.float32)}
    if kind == "layer":
        p["bias"] = rng.normal(size=48).astype(np.float32)
    jx, tx = _both(x, dtype)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    fn_j = jlayers.apply_layernorm if kind == "layer" else \
        jlayers.apply_rmsnorm
    fn_t = tlayers.apply_layernorm if kind == "layer" else \
        tlayers.apply_rmsnorm
    out = fn_t(tp, tx, 1e-5)
    assert out.dtype == tx.dtype
    _close(out, fn_j(jp, jx, 1e-5), dtype)


@pytest.mark.parametrize("arch,kind", [("starcoder2-15b", "layer"),
                                       ("qwen2-7b", "rms"),
                                       ("recurrentgemma-2b", "rms")])
def test_init_norm_picks_the_family_norm(arch, kind):
    cfg = tget(arch)
    p = tlayers.init_norm(cfg, 8, "cpu")
    assert ("bias" in p) == (kind == "layer")
    assert ("bias" in jlayers.init_norm(jget(arch), 8)) == (kind == "layer")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["qwen2-7b", "chatglm3-6b"])
def test_rope(arch, dtype):
    """Half-split RoPE over the whole head (qwen2) and over its first half
    (chatglm3, rotary_pct 0.5), at odd positions."""
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 3, 7, 32)).astype(np.float32)
    pos = np.array([0, 1, 5, 17, 100, 1023, 4095], np.int32)
    jx, tx = _both(x, dtype)
    cfg_j = jget(arch).replace(rope_theta=1e6)
    cfg_t = tget(arch).replace(rope_theta=1e6)
    out = tlayers.apply_rope(tx, torch.from_numpy(pos)[None, None], cfg_t)
    _close(out, jlayers.apply_rope(jx, jnp.asarray(pos)[None, None], cfg_j),
           dtype)
    if cfg_t.rotary_pct < 1:               # the tail passes through
        assert torch.equal(out[..., 16:], tx[..., 16:])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["qwen2-7b", "starcoder2-15b"])
def test_mlp(arch, dtype):
    """SwiGLU (qwen2) and the plain tanh-GELU MLP (starcoder2)."""
    cfg_j = jget(arch).replace(dtype=dtype)
    cfg_t = tget(arch).replace(dtype=dtype)
    jp = jlayers.init_mlp(jax.random.key(3), cfg_j, 64, 128)
    tp = _params(jp)
    assert ("w_gate" in tp) == cfg_t.mlp_gated
    x = np.random.default_rng(3).normal(size=(2, 5, 64)).astype(np.float32)
    jx, tx = _both(x, dtype)
    _close(tlayers.apply_mlp(tp, cfg_t, tx), jlayers.apply_mlp(jp, cfg_j, jx),
           dtype)


@pytest.mark.parametrize("tie", [False, True])
def test_embedding_and_head(tie):
    cfg_j = jget("qwen2-7b").replace(dtype="float32", tie_embeddings=tie)
    cfg_t = tget("qwen2-7b").replace(dtype="float32", tie_embeddings=tie)
    je = jlayers.init_embedding(jax.random.key(4), cfg_j)
    jh = jlayers.init_lm_head(jax.random.key(5), cfg_j)
    assert (jh == {}) == tie
    te, th = _params(je), _params(jh)
    toks = np.random.default_rng(4).integers(0, cfg_j.vocab_size, (2, 9))
    jx = jlayers.embed_tokens(je, jnp.asarray(toks, jnp.int32))
    tx = tlayers.embed_tokens(te, torch.from_numpy(toks.astype(np.int32)))
    _close(tx, jx)
    _close(tlayers.lm_logits(th, te, cfg_t, tx),
           jlayers.lm_logits(jh, je, cfg_j, jx))


def _qkv(b, hq, hkv, s, d, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, hq, s, d)).astype(np.float32),
            rng.normal(size=(b, hkv, s, d)).astype(np.float32),
            rng.normal(size=(b, hkv, s, d)).astype(np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hq,hkv,s,window,chunk", [
    (4, 2, 37, 0, 16),      # GQA, causal, odd length (chunks 12 -> 37)
    (4, 1, 45, 8, 9),       # MQA, window 8, five chunks of 9
    (2, 2, 30, 16, 1024),   # MHA, window wider than half, one chunk
])
def test_chunked_attention(hq, hkv, s, window, chunk, dtype):
    """Both lowerings on CPU tensors (the plain mirror) against JAX."""
    arrays = _qkv(2, hq, hkv, s, 16, seed=s + window)
    jq, jk, jv = (_both(a, dtype)[0] for a in arrays)
    tq, tk, tv = (_both(a, dtype)[1] for a in arrays)
    want = jattn.chunked_attention(jq, jk, jv, causal=True, window=window,
                                   q_chunk=chunk, kv_chunk=chunk)
    for impl in ("fused", "reference"):
        got = tattn.chunked_attention(tq, tk, tv, causal=True, window=window,
                                      q_chunk=chunk, kv_chunk=chunk,
                                      impl=impl)
        assert got.dtype == tq.dtype and got.shape == tq.shape
        _close(got, want, dtype)


def test_chunked_attention_fit():
    assert [tattn._fit(s, c) for s, c in ((1500, 1024), (37, 16), (8, 64),
                                          (2560, 1024))] == [750, 1, 8, 640]


def test_chunked_attention_refuses_an_unknown_lowering():
    q = torch.zeros(1, 1, 4, 16)
    with pytest.raises(ValueError, match="impl"):
        tattn.chunked_attention(q, q, q, impl="pallas")


@pytest.mark.parametrize("window", [0, 6])
def test_decode_attention_on_a_ring(window):
    """One position against a cache: full (slots = positions, the tail not
    yet written) and a ring of 6 slots after 11 writes (slot = pos % 6)."""
    rng = np.random.default_rng(5 + window)
    b, hq, hkv, d = 2, 4, 2, 16
    slots, pos = (6, 10) if window else (16, 10)
    q = rng.normal(size=(b, hq, d)).astype(np.float32)
    k = rng.normal(size=(b, hkv, slots, d)).astype(np.float32)
    v = rng.normal(size=(b, hkv, slots, d)).astype(np.float32)
    cfg_j = jget("qwen2-7b").replace(attn_window=window)
    cfg_t = tget("qwen2-7b").replace(attn_window=window)
    jpos = jdecode._ring_positions(cfg_j, jnp.int32(pos), slots)
    from repro_torch.models import decode as tdecode
    tpos = tdecode._ring_positions(
        cfg_t, torch.tensor(pos, dtype=torch.int32), slots)
    np.testing.assert_array_equal(tpos.numpy(), np.asarray(jpos))
    jo = jattn.decode_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), jpos, pos + 1, window=window)
    to = tattn.decode_attention(torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(v), tpos,
                                torch.tensor(pos + 1), window=window)
    for got, want in zip(to, jo):
        _close(got, want)
    _close(tattn.finalize_partial(*to), jattn.finalize_partial(*jo))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_scale_on_a_prescaled_q(dtype):
    """K9's plain version with ``scale=1.0`` on q pre-scaled in f32 and
    rounded to its dtype (what the LM's prefill passes) equals JAX's
    chunked attention; the default scale is unchanged."""
    arrays = _qkv(1, 4, 2, 40, 32, seed=6)
    tq, tk, tv = (_both(a, dtype)[1] for a in arrays)
    jq, jk, jv = (_both(a, dtype)[0] for a in arrays)
    pre = tattn.prescale(tq)
    got = fa.flash_attention_plain(pre, tk, tv, causal=True, window=12,
                                   scale=1.0)
    _close(got, jattn.chunked_attention(jq, jk, jv, causal=True, window=12),
           dtype)
    assert torch.equal(fa.flash_attention_fwd(pre, tk, tv, window=12,
                                              scale=1.0), got)
    assert torch.equal(
        fa.flash_attention_plain(tq, tk, tv, window=12),
        fa.flash_attention_plain(tq, tk, tv, window=12, scale=None))
    if dtype == "bfloat16":
        lim = fa.bf16_error_bound(got, pre, tk, tv, window=12, scale=1.0)
        assert torch.equal(lim, fa.bf16_error_bound(
            got, pre, tk, tv, window=12, scale=1.0))
        assert bool((lim > 0).all())


def test_softplus_has_no_threshold():
    x = torch.tensor([-30.0, 0.0, 19.0, 20.5, 40.0, 90.0])
    np.testing.assert_allclose(
        trglru.softplus(x).numpy(),
        np.asarray(jax.nn.softplus(jnp.asarray(x.numpy()))), rtol=1e-7)


@pytest.mark.parametrize("s", [1, 2, 7, 33, 64])
def test_associative_scan_is_the_recurrence(s):
    """The log-depth scan equals h_t = a_t h_{t-1} + b_t step by step."""
    g = torch.Generator().manual_seed(s)
    a = torch.rand((2, s, 5), generator=g, dtype=torch.float64)
    b = torch.randn((2, s, 5), generator=g, dtype=torch.float64)
    _, h = trglru.associative_scan(a, b)
    want, prev = [], torch.zeros(2, 5, dtype=torch.float64)
    for t in range(s):
        prev = a[:, t] * prev + b[:, t]
        want.append(prev)
    torch.testing.assert_close(h, torch.stack(want, 1), rtol=1e-12,
                               atol=1e-12)


def _rglru_case(dtype, seed=7):
    cfg_j = jget("recurrentgemma-2b").replace(dtype=dtype)
    cfg_t = tget("recurrentgemma-2b").replace(dtype=dtype)
    jp = jrglru.init_rglru(jax.random.key(seed), cfg_j, cfg_j.d_model)
    x = np.random.default_rng(seed).normal(
        size=(2, 23, cfg_j.d_model)).astype(np.float32)
    return cfg_j, cfg_t, jp, _params(jp), _both(x, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rglru_forward_prefill_state_and_step(dtype):
    """The forward and the state after it (JAX's ``_rglru_prefill``) over
    22 positions; then one step from that state, against JAX's step and
    against the port's own forward over all 23 positions."""
    cfg_j, cfg_t, jp, tp, (jx, tx) = _rglru_case(dtype)
    got, st = trglru.rglru_forward(tp, cfg_t, tx[:, :-1], return_state=True)
    jy, jst = jdecode._rglru_prefill({"rec": jp}, cfg_j, jx[:, :-1])
    _close(got, jy, dtype)
    state_tol = F32_TOL if dtype == "float32" else 1e-2
    for k in ("h", "conv_tail"):
        _close(st[k], jst[k], "float32", state_tol)
    y, st2 = trglru.rglru_step(tp, cfg_t, tx[:, -1], st)
    jy2, jst2 = jrglru.rglru_step(jp, cfg_j, jx[:, -1], jst)
    _close(y, jy2, dtype)
    for k in ("h", "conv_tail"):
        _close(st2[k], jst2[k], "float32", state_tol)
    _close(y, trglru.rglru_forward(tp, cfg_t, tx)[:, -1].float().numpy(),
           dtype)


def test_rglru_init_matches_the_reference_layout():
    cfg_j, cfg_t, jp, _, _ = _rglru_case("bfloat16")
    tp = trglru.init_rglru(torch.Generator().manual_seed(0), cfg_t,
                           cfg_t.d_model, "cpu")
    jflat = jax.tree_util.tree_flatten_with_path(jp)[0]
    assert len(jflat) == sum(1 for _ in _leaves(tp))
    for path, leaf in jflat:
        t = _get(tp, [k.key for k in path])
        assert tuple(t.shape) == leaf.shape
        assert str(t.dtype).split(".")[-1] == str(leaf.dtype)
    lam = tp["lambda"]
    a = torch.exp(-8.0 * trglru.softplus(lam))   # decay at r = 1
    assert float(a.min()) >= 0.9 - 1e-6 and float(a.max()) <= 0.999 + 1e-6


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def _get(tree, keys):
    for k in keys:
        tree = tree[k]
    return tree
