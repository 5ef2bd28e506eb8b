"""The ssm family (``repro_torch.models.ssm``: the xLSTM blocks of
xlstm-125m at ``SMOKE_CONFIG``, one mLSTM and one sLSTM layer) against the
JAX package's ``repro/models/ssm.py``, from JAX's params carried across
(``convert.lm_params_from_numpy``).

The scans and the steps from the same numpy inputs, and the prefill's
final states: the port returns each scan's own final carry, JAX replays
the step form over the sequence (``decode._mlstm_final_state`` /
``_slstm_final_state``); both within ``F32_TOL`` (2e-3) in float32 and
``bf16_tol`` of the largest value in bf16 (the states stay float32 in
both; the bf16 activations feeding them differ by an ulp). The model:
prefill, decode, a step from JAX's prefill state, the loss and the decode
states, as ``tests/_torch_lm.py`` holds the other families.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_lm import (F32_TOL, assert_logits_close, bf16_tol, configs, f32,
                       inputs, jax_batch, jbuild, serve_both, tbuild,
                       torch_batch)
from repro.models import decode as jdecode
from repro.models import ssm as jssm
from repro_torch import convert
from repro_torch.models import ssm as tssm

ARCH = "xlstm-125m"
KINDS = {"mlstm": (jssm.init_mlstm, jssm.mlstm_scan, jssm.mlstm_step,
                   tssm.mlstm_scan, tssm.mlstm_step),
         "slstm": (jssm.init_slstm, jssm.slstm_scan, jssm.slstm_step,
                   tssm.slstm_scan, tssm.slstm_step)}


def _close(got, want, dtype, what):
    g, w = f32(got), f32(want)
    assert g.shape == w.shape, (what, g.shape, w.shape)
    if dtype == "float32":
        np.testing.assert_allclose(g, w, rtol=F32_TOL, atol=F32_TOL,
                                   err_msg=what)
    else:
        assert np.abs(g - w).max() <= bf16_tol(w), (what,
                                                     np.abs(g - w).max())


def _block(kind, dtype, seed=0):
    jcfg, tcfg = configs(ARCH, dtype=dtype)
    jp = KINDS[kind][0](jax.random.key(seed), jcfg, jcfg.d_model)
    tp = convert.lm_params_from_numpy(jax.device_get(jp), device="cpu")
    return jcfg, tcfg, jp, tp


def _x(cfg, b, s, dtype, seed=1):
    x = np.random.default_rng(seed).normal(
        size=(b, s, cfg.d_model)).astype(np.float32)
    return jnp.asarray(x).astype(dtype), torch.from_numpy(x).to(
        getattr(torch, dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_scan_and_final_state_match_jax(kind, dtype):
    """The full-sequence scan over 19 positions, and its final carry
    against JAX's step replay (the state JAX's prefill returns)."""
    jcfg, tcfg, jp, tp = _block(kind, dtype)
    jx, tx = _x(jcfg, 2, 19, dtype)
    want = jax.jit(lambda p, x: KINDS[kind][1](p, jcfg, x))(jp, jx)
    got, state = KINDS[kind][3](tp, tcfg, tx, return_state=True)
    assert got.dtype == tx.dtype
    _close(got, want, dtype, f"{kind} scan")
    final = jdecode._mlstm_final_state if kind == "mlstm" else \
        jdecode._slstm_final_state
    jstate = jax.jit(lambda p, x: final(p, jcfg, x))(jp, jx)
    assert sorted(state) == sorted(jstate)
    for key in state:
        assert state[key].dtype == torch.float32
        _close(state[key], jstate[key], dtype, f"{kind} final {key}")
    # without return_state the same output
    assert torch.equal(KINDS[kind][3](tp, tcfg, tx), got)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_steps_match_jax_and_the_scan(kind, dtype):
    """Five steps from the initial state (sLSTM's n starts at 1e-6) against
    JAX's steps, each output and state; the port's steps against its own
    scan."""
    jcfg, tcfg, jp, tp = _block(kind, dtype, seed=2)
    jx, tx = _x(jcfg, 3, 5, dtype, seed=4)
    if kind == "mlstm":
        jst, tst = jssm.mlstm_init_state(jcfg, 3), tssm.mlstm_init_state(
            tcfg, 3, "cpu")
    else:
        jst = jssm.slstm_init_state(jcfg, 3, jcfg.d_model)
        tst = tssm.slstm_init_state(tcfg, 3, tcfg.d_model, "cpu")
    for key in tst:
        np.testing.assert_array_equal(f32(tst[key]), f32(jst[key]))
    jstep = jax.jit(lambda p, x, s: KINDS[kind][2](p, jcfg, x, s))
    ys = []
    for t in range(5):
        jy, jst = jstep(jp, jx[:, t], jst)
        ty, tst = KINDS[kind][4](tp, tcfg, tx[:, t], tst)
        _close(ty, jy, dtype, f"{kind} step {t}")
        for key in tst:
            _close(tst[key], jst[key], dtype, f"{kind} step {t} {key}")
        ys.append(ty)
    scan, state = KINDS[kind][3](tp, tcfg, tx, return_state=True)
    _close(torch.stack(ys, 1), scan, dtype, f"{kind} steps against scan")
    for key in state:
        _close(tst[key], state[key], dtype, f"{kind} steps' {key}")


def test_init_layout_matches_jax():
    """The block trees: keys, shapes, dtypes; b_if's zeros and threes."""
    for kind in KINDS:
        jcfg, tcfg = configs(ARCH)
        jp = KINDS[kind][0](jax.random.key(0), jcfg, jcfg.d_model)
        init = tssm.init_mlstm if kind == "mlstm" else tssm.init_slstm
        tp = init(torch.Generator().manual_seed(0), tcfg, tcfg.d_model, "cpu")
        flat_j = jax.tree_util.tree_flatten_with_path(jp)[0]
        want = {jax.tree_util.keystr(k): v for k, v in flat_j}
        got = {f"['{a}']" + (f"['{b}']" if isinstance(v, dict) else ""): w
               for a, v in tp.items()
               for b, w in (v.items() if isinstance(v, dict) else [(a, v)])}
        assert sorted(got) == sorted(want)
        for k, t in got.items():
            assert tuple(t.shape) == want[k].shape, k
            assert str(t.dtype).replace("torch.", "") == str(want[k].dtype)
    np.testing.assert_array_equal(
        tssm.init_mlstm(None, tcfg, tcfg.d_model, "cpu")["b_if"].numpy(),
        np.asarray(jssm.init_mlstm(jax.random.key(0), jcfg,
                                   jcfg.d_model)["b_if"]))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_decode_loss_and_states_match_jax(dtype):
    """The model (mLSTM, sLSTM; no FFN): prefill and 3 decode steps, a
    step from JAX's prefill state, the loss, and the states after the
    steps."""
    out = serve_both(ARCH, dtype)
    assert_logits_close(*out["prefill"], dtype, "prefill")
    for i, (got, want) in enumerate(out["decode"]):
        assert_logits_close(got, want, dtype, f"decode step {i}")
    assert_logits_close(*out["injected"], dtype, "decode from the JAX state")
    got, want = (float(f32(x)) for x in out["loss"])
    assert abs(got - want) <= (2e-5 if dtype == "float32" else 2e-3) * want
    assert float(f32(out["aux"][0])) == 0.0
    ts, js = out["state"]
    assert int(ts["pos"]) == int(js["pos"])
    for i, (t, j) in enumerate(zip(ts["layers"], js["layers"])):
        assert sorted(t) == sorted(j)
        for key in t:
            _close(t[key], j[key], dtype, f"layer {i} {key}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_state_is_jax_final_state(dtype):
    """The prefill's decode state (each scan's carry) against JAX's
    prefill state (the step replay) right after a 16-token prompt."""
    jcfg, tcfg = configs(ARCH, dtype=dtype)
    japi, tapi = jbuild(jcfg), tbuild(tcfg)
    jp = jax.jit(japi.init)(jax.random.key(1))
    tp = convert.lm_params_from_numpy(jax.device_get(jp), device="cpu")
    arr = inputs(jcfg, 2, 16, 3)
    _, js = jax.jit(japi.prefill)(jp, jax_batch(arr, jcfg))
    _, ts = tapi.prefill(tp, torch_batch(arr, tcfg))
    assert int(ts["pos"]) == int(js["pos"]) == 16
    kinds = tcfg.pattern()
    assert kinds == ("mlstm", "slstm")
    for kind, t, j in zip(kinds, ts["layers"], js["layers"]):
        assert sorted(t) == sorted(j)
        for key in t:
            _close(t[key], j[key], dtype, f"{kind} {key}")


@pytest.mark.parametrize("kind,leaf", [("mlstm", "m"), ("mlstm", "n"),
                                       ("slstm", "m"), ("slstm", "c")])
def test_serve_against_forward_sees_a_wrong_carry(monkeypatch, kind, leaf):
    """The float32 check that ``chip_smoke.py`` makes of the xLSTM prefill's
    carry: prefill + decode against the full forward at the same positions
    holds within ``F32_TOL`` (absolute and relative), and a final carry
    with one leaf off by 0.05 breaks it."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import transformer as tfm
    from repro_torch.models.layers import lm_logits
    cfg = get_smoke_config(ARCH).replace(dtype="float32")
    api = tbuild(cfg)
    params = api.init(0, device="cpu")
    b, p, t = 2, 48, 8
    toks = torch.from_numpy(inputs(cfg, b, p + t)["tokens"])
    hidden, _ = tfm.forward(params, cfg, toks, return_hidden=True)
    want = lm_logits(params["head"], params["embed"], cfg,
                     hidden[:, p - 1:]).numpy()

    def serve():
        logits, st = api.prefill(params, {"tokens": toks[:, :p]},
                                 pad_cache_to=p + t)
        out = [logits]
        for i in range(t):
            logits, st = api.decode_step(params, st, toks[:, p + i])
            out.append(logits)
        return np.stack([x.numpy() for x in out], 1)

    np.testing.assert_allclose(serve(), want, rtol=F32_TOL, atol=F32_TOL)
    name = kind + "_scan"
    real = getattr(tssm, name)

    def off(lp, c, x, *, return_state=False):
        if not return_state:
            return real(lp, c, x)
        y, st = real(lp, c, x, return_state=True)
        return y, dict(st, **{leaf: st[leaf] + 0.05})
    monkeypatch.setattr(tssm, name, off)
    got = serve()
    assert not np.allclose(got, want, rtol=F32_TOL, atol=F32_TOL)
