"""The moe family (``repro_torch.models.moe``; moonshot-v1-16b-a3b and
arctic-480b at ``SMOKE_CONFIG``) against the JAX package's
``repro/models/moe.py`` and its models, from JAX's params carried across
(``convert.lm_params_from_numpy``).

Integer results are bit-equal: the expert ids (a tie to the lower expert,
as ``jax.lax.top_k``: a zero router makes every probability equal, and
duplicated router columns tie two experts exactly), ``positions_within``,
the capacity and the dropped slots (``capacity_factor`` 0.5 overflows).
Floats: ``moe_local`` and ``apply_moe`` under every strategy (without a
mesh all run ``moe_local``, as in JAX) within ``F32_TOL`` in float32 and
``bf16_tol`` in bf16 (XLA keeps the gated product in f32 where torch
rounds each bf16 op: single outputs land a few ulps apart); the models' prefill, decode, loss and aux within the tolerances of
``tests/_torch_lm.py``, arctic with its dense residual and 4/2 GQA heads,
moonshot also in JAX's stacked layout (its full config stacks its 48
layers).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_lm import (F32_TOL, assert_logits_close, bf16_tol, configs, f32,
                       inputs, jax_batch, jbuild, serve_both, tbuild,
                       torch_batch)
from repro.models import moe as jmoe
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.models import moe as tmoe

ARCHS = ("moonshot-v1-16b-a3b", "arctic-480b")


def _moe_params(jcfg, seed=0):
    jp = jmoe.init_moe(jax.random.key(seed), jcfg, jcfg.d_model)
    return jp, convert.lm_params_from_numpy(jax.device_get(jp), device="cpu")


def _x(cfg, t, seed=1):
    return np.random.default_rng(seed).normal(
        size=(t, cfg.d_model)).astype(np.float32)


def _router(case, jp):
    r = np.array(jp["router"])
    if case == "zero":                 # every probability equal
        r[:] = 0.0
    elif case == "duplicate":          # experts 1 and 5, 2 and 6 tie exactly
        r[:, 5], r[:, 6] = r[:, 1], r[:, 2]
    return r


@pytest.mark.parametrize("case", ["random", "zero", "duplicate"])
@pytest.mark.parametrize("arch", ARCHS)
def test_topk_routing_ids_bit_equal(arch, case):
    jcfg, tcfg = configs(arch, dtype="float32")
    jp, _ = _moe_params(jcfg)
    r = _router(case, jp)
    x = _x(jcfg, 64)
    jg, je, ja = jmoe.topk_routing(jnp.asarray(r), jnp.asarray(x),
                                   jcfg.top_k)
    tg, te, ta = tmoe.topk_routing(torch.from_numpy(r), torch.from_numpy(x),
                                   tcfg.top_k)
    assert te.dtype == torch.int32
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(float(ta), float(ja), rtol=1e-6)
    if case == "zero":
        assert (te.numpy() == np.arange(tcfg.top_k)).all()
    if case == "duplicate":            # the lower of a tied pair first
        ids = te.numpy()
        for lo, hi in ((1, 5), (2, 6)):
            both = (ids == lo).any(1) & (ids == hi).any(1)
            rows = np.nonzero(both)[0]
            for row in rows:
                assert list(ids[row]).index(lo) < list(ids[row]).index(hi)


@pytest.mark.parametrize("n,buckets,seed", [(1, 4, 0), (1000, 16, 1),
                                            (777, 64, 2), (4096, 9, 3)])
def test_positions_within_bit_equal(n, buckets, seed):
    ids = np.random.default_rng(seed).integers(0, buckets, n).astype(
        np.int32)
    want = np.asarray(jmoe.positions_within(jnp.asarray(ids), buckets))
    got = tmoe.positions_within(torch.from_numpy(ids), buckets)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    got64 = tmoe.positions_within(torch.from_numpy(ids).long(), buckets)
    np.testing.assert_array_equal(got64.numpy(), want)


@pytest.mark.parametrize("t,k,buckets,factor", [
    (1, 1, 8, 1.25), (8, 6, 64, 1.25), (8192, 6, 64, 1.25), (64, 2, 8, 0.5),
    (40, 2, 8, 8.0), (3, 2, 128, 1.0), (8448, 6, 64, 8.0)])
def test_capacity_equals_jax(t, k, buckets, factor):
    assert tmoe._capacity(t, k, buckets, factor) == \
        jmoe._capacity(t, k, buckets, factor)


@pytest.mark.parametrize("model_size", [1, 2, 4, 16, 64])
@pytest.mark.parametrize("t_local", [1, 8, 4096, 65536])
@pytest.mark.parametrize("arch", ARCHS)
def test_strategy_cost_and_choice_equal_jax(arch, t_local, model_size):
    from repro.configs import get_config as jget_config
    cfg, jcfg = get_config(arch), jget_config(arch)
    assert tmoe.moe_strategy_cost(cfg, t_local, model_size) == \
        jmoe.moe_strategy_cost(jcfg, t_local, model_size)
    assert tmoe.choose_strategy(cfg, t_local, model_size) == \
        jmoe.choose_strategy(jcfg, t_local, model_size)


@pytest.mark.parametrize("cf", [1.25, 0.5])
@pytest.mark.parametrize("case", ["random", "zero"])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_local_and_drops_match_jax(arch, case, cf):
    """``moe_local`` within F32_TOL, and the dispatch's integers (expert
    ids, positions, capacity, dropped slots) bit-equal; at capacity factor
    0.5 slots overflow and are dropped (with a zero router every token goes
    to experts 0 and 1, so nearly all are)."""
    jcfg, tcfg = configs(arch, dtype="float32", capacity_factor=cf)
    jp, tp = _moe_params(jcfg)
    r = _router(case, jp)
    x = _x(jcfg, 40, seed=3)
    jy, jaux = jmoe.moe_local(jnp.asarray(r), jp.get("w_gate"), jp["w_up"],
                              jp["w_down"], jcfg, jnp.asarray(x))
    ty, taux = tmoe.moe_local(torch.from_numpy(r), tp.get("w_gate"),
                              tp["w_up"], tp["w_down"], tcfg,
                              torch.from_numpy(x))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=F32_TOL,
                               atol=F32_TOL)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-6)
    # the integers of the dispatch
    _, je, _ = jmoe.topk_routing(jnp.asarray(r), jnp.asarray(x), jcfg.top_k)
    _, te, _ = tmoe.topk_routing(torch.from_numpy(r), torch.from_numpy(x),
                                 tcfg.top_k)
    flat = np.asarray(je).reshape(-1)
    jpos = np.asarray(jmoe.positions_within(jnp.asarray(flat),
                                            jcfg.num_experts))
    tpos = tmoe.positions_within(te.reshape(-1).long(), tcfg.num_experts)
    np.testing.assert_array_equal(tpos.numpy(), jpos)
    cap = tmoe._capacity(40, tcfg.top_k, tcfg.num_experts, cf)
    assert cap == jmoe._capacity(40, jcfg.top_k, jcfg.num_experts, cf)
    dropped = int((tpos >= cap).sum())
    assert dropped == int((jpos >= cap).sum())
    if cf == 0.5:
        assert dropped > 0
    if case == "zero" and cf == 0.5:   # 80 slots on experts 0 and 1, cap 8
        assert dropped == 2 * 40 - 2 * cap


@pytest.mark.parametrize("strategy", ["local", "auto", "move_data",
                                      "move_compute"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_apply_moe_every_strategy_without_a_mesh(arch, dtype, strategy):
    """Without a mesh every strategy runs ``moe_local`` in both packages
    (arctic adds its dense residual MLP): (B, S, d) in, (y, aux) out."""
    jcfg, tcfg = configs(arch, dtype=dtype)
    jcfg = jcfg.replace(parallel=jcfg.parallel.replace(
        moe_strategy=strategy))
    tcfg = tcfg.replace(parallel=tcfg.parallel.replace(
        moe_strategy=strategy))
    jp, tp = _moe_params(jcfg)
    assert ("dense" in tp) == (arch == "arctic-480b")
    x = _x(jcfg, 2 * 24, seed=4).reshape(2, 24, jcfg.d_model)
    jy, jaux = jmoe.apply_moe(jp, jcfg, jnp.asarray(x).astype(dtype))
    ty, taux = tmoe.apply_moe(tp, tcfg, torch.from_numpy(x).to(
        getattr(torch, dtype)))
    assert ty.shape == (2, 24, tcfg.d_model) and ty.dtype == \
        getattr(torch, dtype)
    if dtype == "float32":
        np.testing.assert_allclose(f32(ty), f32(jy), rtol=F32_TOL,
                                   atol=F32_TOL)
    else:
        assert np.abs(f32(ty) - f32(jy)).max() <= bf16_tol(f32(jy))
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5)


CASES = {
    "moonshot-v1-16b-a3b": dict(arch="moonshot-v1-16b-a3b"),
    "moonshot-v1-16b-a3b-stacked": dict(arch="moonshot-v1-16b-a3b",
                                        scan_layers=True),
    "arctic-480b": dict(arch="arctic-480b"),
    "arctic-480b-overflow": dict(arch="arctic-480b", capacity_factor=0.5),
}


class _Routing:
    """Records every ``topk_routing`` call's expert ids and router logits
    in both packages, in call order (the JAX side through an ordered
    ``jax.debug.callback``, so under ``jit`` and ``scan`` too)."""

    def __enter__(self):
        self.jax, self.port = [], []
        self._j, self._t = jmoe.topk_routing, tmoe.topk_routing

        def jrec(r, x, k):
            out = self._j(r, x, k)
            jax.debug.callback(
                lambda e, lg: self.jax.append((np.asarray(e),
                                               np.asarray(lg))),
                out[1], x.astype(jnp.float32) @ r, ordered=True)
            return out

        def trec(r, x, k):
            out = self._t(r, x, k)
            self.port.append((out[1].numpy(), (x.float() @ r).numpy()))
            return out
        jmoe.topk_routing, tmoe.topk_routing = jrec, trec
        return self

    def __exit__(self, *exc):
        jmoe.topk_routing, tmoe.topk_routing = self._j, self._t

    def take(self):
        """The calls since the last take: [(port, jax)] per layer."""
        calls = list(zip(self.port, self.jax))
        assert len(self.port) == len(self.jax)
        self.jax, self.port = [], []
        return calls


def _diverged(calls, rows, cfg, excluded):
    """Rows whose routing left JAX's, layer by layer. A token whose expert
    ids differ from JAX's (a flip) must be a near-tie of JAX's router
    logits: the gap between its first differing rank and the next below
    twice the layer's largest |port - JAX| logit. A flip also moves the
    slots of the later tokens on its two experts (``positions_within``'s
    order), so a token kept on one side and dropped on the other must
    follow a flip of its layer. Both tokens' rows are excluded from then
    on; with no flip the dropped slots are bit-equal. Returns (excluded
    rows, flips)."""
    excluded, flips = set(excluded), 0
    e, k = cfg.num_experts, cfg.top_k
    for (te, tl), (je, jl) in calls:
        t = je.shape[0]
        per_row = t // rows
        noise = float(np.abs(tl - jl).max())
        cap = jmoe._capacity(t, k, e, cfg.capacity_factor)
        jkeep = np.asarray(jmoe.positions_within(
            jnp.asarray(je.reshape(-1)), e)).reshape(t, k) < cap
        tkeep = tmoe.positions_within(torch.from_numpy(te.reshape(-1)),
                                      e).numpy().reshape(t, k) < cap
        flipped = np.nonzero((te != je).any(1))[0]
        moved = np.nonzero((tkeep != jkeep).any(1))[0]
        for tok in flipped:
            if tok // per_row in excluded:
                continue
            r0 = int(np.nonzero(te[tok] != je[tok])[0][0])
            srt = np.sort(jl[tok])[::-1]
            gap = float(srt[r0] - srt[r0 + 1])
            assert gap <= 2 * noise, (tok, te[tok], je[tok], gap, noise)
            flips += 1
        for tok in moved:
            assert len(flipped) and flipped.min() < tok or tok in flipped, \
                (tok, "dropped on one side only, after no flip")
        excluded |= {int(tok) // per_row for tok in np.concatenate(
            [flipped, moved])}
    return excluded, flips


@pytest.mark.parametrize("case", sorted(CASES))
def test_prefill_decode_loss_and_aux_match_jax_f32(case):
    """The models from JAX's params in float32: prefill and decode logits
    (a decode step routes B = 2 tokens), a step from JAX's prefill state,
    the loss with its ``AUX_WEIGHT * aux`` term, the aux summed over the
    layers, and the caches; at capacity factor 0.5 with slots dropped in
    both."""
    kw = dict(CASES[case])
    arch = kw.pop("arch")
    out = serve_both(arch, "float32", **kw)
    assert_logits_close(*out["prefill"], "float32", f"{case} prefill")
    for i, (got, want) in enumerate(out["decode"]):
        assert_logits_close(got, want, "float32", f"{case} decode step {i}")
    assert_logits_close(*out["injected"], "float32",
                        f"{case} decode from the JAX state")
    for key in ("loss", "aux"):
        got, want = (float(f32(x)) for x in out[key])
        assert want > 0.0 and abs(got - want) <= 2e-5 * want, key
    ts, js = out["state"]
    tl, jl = ts["layers"], js["layers"]
    pairs = [(tl[k], jl[k]) for k in tl] if isinstance(tl, dict) else \
        [(t[k], j[k]) for t, j in zip(tl, jl) for k in t]
    for t, j in pairs:
        assert tuple(t.shape) == tuple(j.shape)
        np.testing.assert_allclose(f32(t), f32(j), rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("case", sorted(CASES))
def test_prefill_decode_loss_and_aux_match_jax_bf16(case):
    """The same in bf16, where routing is a discrete decision on rounded
    activations: a token whose k-th and (k+1)-th router logits nearly tie
    may take another expert in the port than in JAX (one bf16 ulp of its
    hidden state apart). Expert ids are compared layer by layer
    (``_diverged``): every flip must be a near-tie, and a row's logits are
    held to ``bf16_tol`` while its routing (and, under dropped slots, every
    earlier row's) agrees with JAX's; at least one row is compared at every
    step. The loss and aux are compared when the loss's forward has no
    flip."""
    kw = dict(CASES[case])
    arch = kw.pop("arch")
    jcfg, tcfg = configs(arch, dtype="bfloat16", **kw)
    japi, tapi = jbuild(jcfg), tbuild(tcfg)
    jp = jax.jit(japi.init)(jax.random.key(0))
    tp = convert.lm_params_from_numpy(jax.device_get(jp), device="cpu")
    rows, prompt, steps = 2, 12, 3
    arr = inputs(jcfg, rows, prompt + steps, 1)
    with _Routing() as rec:
        jl, js = jax.jit(lambda p, b: japi.prefill(
            p, b, pad_cache_to=prompt + steps))(jp, jax_batch(arr, jcfg,
                                                               prompt))
        tl, ts = tapi.prefill(tp, torch_batch(arr, tcfg, prompt),
                              pad_cache_to=prompt + steps)
        jax.effects_barrier()
        excluded, flips = _diverged(rec.take(), rows, tcfg, ())
        compared = 0

        def close(got, want, what):
            keep = [r for r in range(rows) if r not in excluded]
            assert keep, (what, excluded)
            g, w = f32(got)[keep], f32(want)[keep]
            assert np.abs(g - w).max() <= bf16_tol(w), what
            return len(keep)
        compared += close(tl, jl, f"{case} prefill")
        jdecode = jax.jit(lambda p, s_, t: japi.decode_step(p, s_, t))
        for i in range(steps):
            tok = arr["tokens"][:, prompt + i]
            jl, js = jdecode(jp, js, jnp.asarray(tok))
            tl, ts = tapi.decode_step(tp, ts, torch.from_numpy(tok))
            jax.effects_barrier()
            excluded, n = _diverged(rec.take(), rows, tcfg, excluded)
            flips += n
            compared += close(tl, jl, f"{case} decode step {i}")
        tloss, tm = tapi.loss(tp, torch_batch(arr, tcfg))
        jloss, jm = jax.jit(japi.loss)(jp, jax_batch(arr, jcfg))
        jax.effects_barrier()
        loss_rows, n = _diverged(rec.take(), rows, tcfg, ())
    assert compared >= steps + 1
    if not loss_rows:
        for got, want in ((tloss, jloss), (tm["aux"], jm["aux"])):
            got, want = float(f32(got)), float(f32(want))
            assert want > 0.0 and abs(got - want) <= 2e-3 * want
