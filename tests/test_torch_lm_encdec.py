"""The audio family (``repro_torch.models.encdec``: whisper-base at
``SMOKE_CONFIG``, 2 + 2 layers over 64 stub frames) against the JAX
package's ``repro/models/encdec.py``, from JAX's params carried across
(``convert.lm_params_from_numpy``): ``encode``, ``forward``, ``prefill``,
``decode_step`` (self-attention on the in-place cache, cross-attention on
the fixed encoder k / v), a step from JAX's prefill state, the loss, and a
step past the cache's end (JAX's ``dynamic_slice`` and
``dynamic_update_slice`` clamp to the last slot). Tolerances as in
``tests/_torch_lm.py``: 2e-3 in float32, ``bf16_tol`` in bf16. The
sinusoidal table, computed on the device in float64 and rounded, is held
to JAX's numpy table within one float32 ulp.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_lm import (F32_TOL, assert_logits_close, configs, f32, inputs,
                       jax_batch, jbuild, serve_both, tbuild, torch_batch)
from repro.models import encdec as jencdec
from repro.models import layers as jlayers
from repro_torch import convert
from repro_torch.models import encdec as tencdec
from repro_torch.models import layers as tlayers

ARCH = "whisper-base"


def _both(dtype, seed=0, **kw):
    jcfg, tcfg = configs(ARCH, dtype=dtype, **kw)
    jp = jax.jit(jbuild(jcfg).init)(jax.random.key(seed))
    tp = convert.lm_params_from_numpy(jax.device_get(jp), device="cpu")
    return jcfg, tcfg, jp, tp


@pytest.mark.parametrize("seq,d", [(1, 8), (64, 64), (1500, 512),
                                   (98, 512)])
def test_sinusoidal_table_matches_jax(seq, d):
    want = np.asarray(jlayers.sinusoidal_positions(seq, d))
    got = tlayers.sinusoidal_positions(seq, d, "cpu").numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_max_ulp(got, want, maxulp=1)
    row = tlayers.sinusoidal_at(torch.tensor(seq - 1, dtype=torch.int32), d)
    np.testing.assert_array_equal(row.numpy(), got[-1])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encode_and_forward_match_jax(dtype):
    jcfg, tcfg, jp, tp = _both(dtype)
    arr = inputs(jcfg, 2, 10, seed=1)
    jb, tb = jax_batch(arr, jcfg), torch_batch(arr, tcfg)
    jmem = jax.jit(lambda p, f: jencdec.encode(p, jcfg, f))(jp, jb["frames"])
    tmem = tencdec.encode(tp, tcfg, tb["frames"])
    assert tmem.shape == (2, tcfg.encoder_seq, tcfg.d_model)
    assert_logits_close(tmem, jmem, dtype, "encode")
    jl, jaux = jax.jit(lambda p, f, t: jencdec.forward(p, jcfg, f, t))(
        jp, jb["frames"], jb["tokens"])
    tl, taux = tencdec.forward(tp, tcfg, tb["frames"], tb["tokens"])
    assert_logits_close(tl, jl, dtype, "forward")
    assert float(taux) == float(jaux) == 0.0
    hidden, _ = tencdec.forward(tp, tcfg, tb["frames"], tb["tokens"],
                                return_hidden=True)
    assert hidden.shape == (2, 10, tcfg.d_model)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_decode_and_loss_match_jax(dtype):
    """Prefill of 12 tokens over the 64 frames, 3 decode steps, a step
    from JAX's prefill state, the loss; in float32 the caches (self k / v
    padded to 15 slots, cross xk / xv) too."""
    out = serve_both(ARCH, dtype)
    assert_logits_close(*out["prefill"], dtype, "prefill")
    for i, (got, want) in enumerate(out["decode"]):
        assert_logits_close(got, want, dtype, f"decode step {i}")
    assert_logits_close(*out["injected"], dtype, "decode from the JAX state")
    got, want = (float(f32(x)) for x in out["loss"])
    assert abs(got - want) <= (2e-5 if dtype == "float32" else 2e-3) * want
    ts, js = out["state"]
    assert int(ts["pos"]) == int(js["pos"]) == 15
    for t, j in zip(ts["layers"], js["layers"]):
        assert sorted(t) == ["k", "v", "xk", "xv"] == sorted(j)
        for key in t:
            assert tuple(t[key].shape) == tuple(j[key].shape)
            if dtype == "float32":
                np.testing.assert_allclose(f32(t[key]), f32(j[key]),
                                           rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_past_the_cache_clamps_as_jax(dtype):
    """A prompt that fills the cache (no padding), then two steps: JAX's
    ``dynamic_slice`` of the position table and ``dynamic_update_slice``
    of the cache clamp to the last slot; the port clamps ``pos`` on the
    device the same way."""
    jcfg, tcfg, jp, tp = _both(dtype, seed=2)
    japi, tapi = jbuild(jcfg), tbuild(tcfg)
    arr = inputs(jcfg, 2, 10, seed=5)
    jl, js = jax.jit(japi.prefill)(jp, jax_batch(arr, jcfg, 8))
    tl, ts = tapi.prefill(tp, torch_batch(arr, tcfg, 8))
    assert ts["layers"][0]["k"].shape[2] == 8
    jstep = jax.jit(japi.decode_step)
    for i in (8, 9):
        tok = arr["tokens"][:, i]
        jl, js = jstep(jp, js, jnp.asarray(tok))
        tl, ts = tapi.decode_step(tp, ts, torch.from_numpy(tok))
        assert_logits_close(tl, jl, dtype, f"step at position {i}")
    assert int(ts["pos"]) == int(js["pos"]) == 10
    if dtype == "float32":
        np.testing.assert_allclose(f32(ts["layers"][1]["k"]),
                                   f32(js["layers"][1]["k"]), rtol=2e-3,
                                   atol=2e-3)


def test_decode_state_layout_and_init():
    """``init_decode_state``: JAX's keys, shapes and dtypes, zeros; the
    params tree: JAX's enc_layers / dec_layers lists."""
    jcfg, tcfg = configs(ARCH)
    want = jencdec.init_decode_state(None, jcfg, 3, 20)
    got = tbuild(tcfg).init_decode_state(3, 20, device="cpu")
    assert got["pos"].dtype == torch.int32 and int(got["pos"]) == 0
    assert len(got["layers"]) == len(want["layers"]) == tcfg.num_layers
    for t, j in zip(got["layers"], want["layers"]):
        for key in j:
            assert tuple(t[key].shape) == j[key].shape
            assert str(t[key].dtype).replace("torch.", "") == \
                str(j[key].dtype)
            assert not t[key].any()
    params = tbuild(tcfg).init(0, device="cpu")
    assert len(params["enc_layers"]) == tcfg.encoder_layers
    assert sorted(params["dec_layers"][0]) == sorted(
        ["ln1", "attn", "ln_x", "xattn", "ln2", "mlp"])
    assert "bias" in params["enc_norm"]       # LayerNorm, as in JAX


def test_attention_runs_without_explicit_positions(monkeypatch):
    """The port's ``_mha`` hands ``chunked_attention`` no positions (K9
    takes only the top-left arange that None stands for): the encoder's
    self-attention non-causal over S_enc, the decoder's causal, the cross
    non-causal at (Sq, S_enc)."""
    from repro_torch.models import attention as tattn
    seen = []
    real = tattn.chunked_attention

    def spy(q, k, v, **kw):
        seen.append((q.shape[2], k.shape[2], kw.get("causal"),
                     kw.get("q_positions"), kw.get("kv_positions")))
        return real(q, k, v, **kw)
    monkeypatch.setattr(tattn, "chunked_attention", spy)
    _, tcfg = configs(ARCH, dtype="float32")
    api = tbuild(tcfg)
    params = api.init(0, device="cpu")
    arr = inputs(tcfg, 2, 7, seed=1)
    api.prefill(params, torch_batch(arr, tcfg))
    s_enc = tcfg.encoder_seq
    assert seen == [(s_enc, s_enc, False, None, None)] * 2 + \
        [(7, 7, True, None, None), (7, s_enc, False, None, None)] * 2
