"""Shared helpers of the LM tests: one set of numpy inputs through the JAX
package and the port, the JAX params carried across leaf by leaf
(``convert.lm_params_from_numpy``).

Tolerances. float32: 2e-3 absolute and relative, the JAX package's own
``test_prefill_decode_match_forward`` tolerance. bf16: every logit within
``bf16_tol(logits) = 2**-5 * max|logits|``, eight bf16 ulps at the logits'
scale: the two frameworks round the same f32 results to bf16 at the same
places, but sums (matmuls, norms) run in another order and XLA's CPU
backend keeps some elementwise chains in f32, so single activations may
land an ulp apart and the difference passes through every layer (the
smoke configs' largest gap is about 3 ulps, 0.047 at |logit| 3.6).
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_smoke_config as jget
from repro.models import build_model as jbuild
from repro_torch import convert
from repro_torch.configs import get_smoke_config as tget
from repro_torch.models import build_model as tbuild

SERVED = ("qwen2-7b", "qwen3-14b", "starcoder2-15b", "chatglm3-6b",
          "llava-next-34b", "recurrentgemma-2b")
F32_TOL = 2e-3


def bf16_tol(logits) -> float:
    return 2.0 ** -5 * float(np.abs(np.asarray(logits, np.float32)).max())


def configs(arch, **kw):
    return jget(arch).replace(**kw), tget(arch).replace(**kw)


def inputs(cfg, batch, seq, seed=0):
    """numpy tokens (batch, seq) and, for the vlm, patch embeddings."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (batch, seq)).astype(
        np.int32)}
    if cfg.family == "vlm":
        out["patch_embeds"] = rng.normal(
            size=(batch, cfg.num_patches, cfg.d_model)).astype(np.float32)
    return out


def jax_batch(arrays, cfg, seq=None):
    out = {"tokens": jnp.asarray(arrays["tokens"][:, :seq])}
    if "patch_embeds" in arrays:
        out["patch_embeds"] = jnp.asarray(arrays["patch_embeds"]).astype(
            cfg.dtype)
    return out


def torch_batch(arrays, cfg, seq=None, device="cpu"):
    out = {"tokens": torch.from_numpy(arrays["tokens"][:, :seq]).to(device)}
    if "patch_embeds" in arrays:
        out["patch_embeds"] = torch.from_numpy(arrays["patch_embeds"]).to(
            device=device, dtype=getattr(torch, cfg.dtype))
    return out


def f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def serve_both(arch, dtype, prompt=12, steps=3, seed=0, **kw):
    """The same params (JAX's init, carried across) and tokens through both
    packages (JAX's functions under ``jit``, as its serving example runs
    them): prefill of ``prompt`` tokens, then ``steps`` decode steps on
    the fixed next tokens, and the loss over prompt + steps tokens; and the
    first decode step from JAX's prefill state carried across
    (``convert.lm_state_from_numpy``). Returns {"prefill": (port, jax),
    "decode": [(port, jax), ...], "injected": (port, jax), "loss": ...,
    "state": ...}."""
    jcfg, tcfg = configs(arch, dtype=dtype, **kw)
    japi, tapi = jbuild(jcfg), tbuild(tcfg)
    jp = jax.jit(japi.init)(jax.random.key(seed))
    tp = convert.lm_params_from_numpy(jax.device_get(jp), device="cpu")
    arr = inputs(jcfg, 2, prompt + steps, seed + 1)
    n_extra = jcfg.num_patches if jcfg.family == "vlm" else 0
    pad = n_extra + prompt + steps
    jprefill = jax.jit(lambda p, b: japi.prefill(p, b, pad_cache_to=pad))
    jdecode = jax.jit(lambda p, s, t: japi.decode_step(p, s, t))
    jl, js = jprefill(jp, jax_batch(arr, jcfg, prompt))
    tl, ts = tapi.prefill(tp, torch_batch(arr, tcfg, prompt),
                          pad_cache_to=pad)
    out = {"prefill": (tl, jl), "decode": []}
    # JAX's prefill state injected into the port's decode step
    injected = convert.lm_state_from_numpy(jax.device_get(js), device="cpu")
    for i in range(steps):
        tok = arr["tokens"][:, prompt + i]
        jl, js = jdecode(jp, js, jnp.asarray(tok))
        tl, ts = tapi.decode_step(tp, ts, torch.from_numpy(tok))
        out["decode"].append((tl, jl))
        if i == 0:
            out["injected"] = (tapi.decode_step(
                tp, injected, torch.from_numpy(tok))[0], jl)
    out["loss"] = (tapi.loss(tp, torch_batch(arr, tcfg))[0],
                   jax.jit(lambda p, b: japi.loss(p, b)[0])(
                       jp, jax_batch(arr, jcfg)))
    out["state"] = (ts, js)
    return out


def assert_logits_close(got, want, dtype, what=""):
    g, w = f32(got), f32(want)
    assert g.shape == w.shape, (what, g.shape, w.shape)
    if dtype == "float32":
        np.testing.assert_allclose(g, w, rtol=F32_TOL, atol=F32_TOL,
                                   err_msg=what)
    else:
        tol = bf16_tol(w)
        assert np.abs(g - w).max() <= tol, (what, np.abs(g - w).max(), tol)


def greedy_agreement(got_tokens, want_tokens, want_logits, tol):
    """Row by row, the first step where the greedy tokens differ must be a
    near-tie of the reference's logits (top-2 gap under ``tol``); that ends
    the row's comparison. Returns (near-ties, decisions compared); raises
    on a difference that is not a near-tie."""
    got, want = np.asarray(got_tokens), np.asarray(want_tokens)
    ties = compared = 0
    for b in range(want.shape[0]):
        for t in range(want.shape[1]):
            compared += 1
            if got[b, t] == want[b, t]:
                continue
            top2 = np.sort(np.asarray(want_logits[t][b], np.float32))[-2:]
            gap = float(top2[1] - top2[0])
            assert gap < tol, (f"row {b} step {t}: token {got[b, t]} "
                               f"against {want[b, t]}, top-2 gap {gap} "
                               f">= {tol}")
            ties += 1
            break
    return ties, compared
