"""The port's training data and optimizer against the JAX package's.

``_batch_for_step`` and ``TokenPipeline`` give the same int32 tokens, bit
for bit, resume included. ``lr_at`` and ``adamw_update`` run on the same
numpy params, grads and state in both packages: the same f32 arithmetic in
the same order per element, so params, m and v agree within 4 f32 ulps of
the element or of the leaf's largest element (transcendentals of the
schedule, ``cos`` and ``pow``, may round an ulp apart; a bf16 result at
most one bf16 ulp, where that ulp flips a rounding).
The port's update walks each leaf in slices (``optimizer.SLICE``); the
tests shrink the slice so that the leaves are cut in several."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import pipeline as jpipe
from repro.optim import optimizer as jopt
from repro_torch import convert
from repro_torch.data import pipeline as tpipe
from repro_torch.optim import optimizer as topt

ULPS = 4 * 2.0 ** -23


@pytest.mark.parametrize("step,rows", [(0, np.arange(8)), (123, np.arange(3)),
                                       (7, np.arange(1, 16, 4))])
def test_batch_for_step_bit_equal(step, rows):
    cfg = dict(vocab_size=152064, seq_len=96, global_batch=16, seed=5)
    np.testing.assert_array_equal(
        tpipe._batch_for_step(tpipe.DataConfig(**cfg), step, rows),
        jpipe._batch_for_step(jpipe.DataConfig(**cfg), step, rows))


@pytest.mark.parametrize("shards", [1, 2])
def test_token_pipeline_bit_equal_and_resumes(shards):
    """Four batches of each package's pipeline (shard 1 of 2 too), then a
    pipeline started at the state the port's reports gives the next."""
    kw = dict(vocab_size=512, seq_len=32, global_batch=4, seed=3)
    jp = jpipe.TokenPipeline(jpipe.DataConfig(**kw),
                             shard_index=shards - 1, num_shards=shards)
    tp = tpipe.TokenPipeline(tpipe.DataConfig(**kw), shard_index=shards - 1,
                             num_shards=shards, device="cpu")
    for _ in range(4):
        t = next(tp)["tokens"]
        assert t.dtype == torch.int32
        np.testing.assert_array_equal(t.numpy(),
                                      np.asarray(next(jp)["tokens"]))
    assert tp.state() == jp.state() == {"seed": 3, "step": 4}
    again = tpipe.TokenPipeline(tpipe.DataConfig(**kw),
                                shard_index=shards - 1, num_shards=shards,
                                start_step=tp.state()["step"], device="cpu")
    np.testing.assert_array_equal(next(again)["tokens"].numpy(),
                                  np.asarray(next(jp)["tokens"]))
    for p in (jp, tp, again):
        p.close()


def test_lr_at_matches():
    jcfg = jopt.OptimizerConfig(warmup_steps=100, total_steps=1000)
    tcfg = topt.OptimizerConfig(warmup_steps=100, total_steps=1000)
    for s in (0, 1, 50, 99, 100, 101, 400, 999, 1000, 5000):
        want = float(jopt.lr_at(jcfg, jnp.asarray(s, jnp.int32)))
        got = float(topt.lr_at(tcfg, torch.tensor(s, dtype=torch.int32)))
        assert abs(got - want) <= 2 * ULPS * abs(want), (s, got, want)
        assert float(topt.lr_at(tcfg, s)) == got


def _tree(rng, dtype):
    """A param-like tree: a matrix, a stacked (L, a, b) leaf, vectors (no
    decay), in a nested dict and a list."""
    def x(*shape):
        return rng.normal(size=shape).astype(np.float32)
    t = {"embed": {"table": x(37, 11)}, "layers_stacked": {
        "w": x(3, 9, 13), "scale": x(3, 13)},
         "layers": [{"b": x(13)}, {"b": x(5)}], "final": x(7)}
    return jax.tree.map(lambda a: jnp.asarray(a).astype(dtype), t)


def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a), jax.device_get(tree))


def _torch(tree):
    return convert.lm_params_from_numpy(_np(tree), device="cpu")


def _assert_close(got, want, dtype):
    g = np.asarray(got.float() if isinstance(got, torch.Tensor) else got,
                   np.float32)
    w = np.asarray(jnp.asarray(want).astype(jnp.float32))
    ulp = 2.0 ** -7 if dtype == "bfloat16" else ULPS
    # a sum that cancels keeps its terms' absolute error: the leaf's scale
    np.testing.assert_allclose(g, w, rtol=ulp,
                               atol=ulp * float(np.abs(w).max()))


@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("step", [0, 150])
def test_adamw_update_matches(monkeypatch, param_dtype, state_dtype, step):
    """One update on shared inputs (JAX's grads carried across): params,
    m, v, grad_norm and lr within 4 f32 ulps (bf16 leaves one bf16 ulp),
    with the leaves cut into slices of 50 elements."""
    monkeypatch.setattr(topt, "SLICE", 50)
    rng = np.random.default_rng(step + len(param_dtype + state_dtype))
    params, grads = _tree(rng, param_dtype), _tree(rng, param_dtype)
    kw = dict(state_dtype=state_dtype, warmup_steps=100, total_steps=1000,
              grad_clip=0.5)
    jcfg, tcfg = jopt.OptimizerConfig(**kw), topt.OptimizerConfig(**kw)
    m, v = _tree(rng, state_dtype), jax.tree.map(
        lambda a: jnp.abs(a), _tree(rng, state_dtype))
    jstate = {"m": m, "v": v, "step": jnp.asarray(step, jnp.int32)}
    tstate = convert.lm_opt_state_from_numpy(_np(jstate), device="cpu")
    tparams = _torch(params)
    jp, js, jstats = jopt.adamw_update(params, grads, jstate, jcfg)
    tp, ts, tstats = topt.adamw_update(tparams, _torch(grads), tstate, tcfg)
    assert tp is tparams                      # updated in place
    for got, want in ((tp, jp), (ts["m"], js["m"]), (ts["v"], js["v"])):
        for g, w in zip(topt.leaves(got), jax.tree.leaves(want)):
            assert g.dtype == getattr(torch, str(w.dtype))
            _assert_close(g, w, str(w.dtype))
    assert int(ts["step"]) == step + 1
    _assert_close(tstats["lr"], jstats["lr"], "float32")
    np.testing.assert_allclose(float(tstats["grad_norm"]),
                               float(jstats["grad_norm"]), rtol=1e-6)
    back = convert.lm_opt_state_to_numpy(ts)
    assert back["step"] == step + 1 and back["step"].dtype == np.int32


def test_global_norm_matches(monkeypatch):
    monkeypatch.setattr(topt, "SLICE", 64)
    g = _tree(np.random.default_rng(4), "float32")
    np.testing.assert_allclose(float(topt.global_norm(_torch(g))),
                               float(jopt.global_norm(g)), rtol=1e-6)


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_init_opt_state_matches(state_dtype):
    p = _tree(np.random.default_rng(1), "bfloat16")
    cfg = dict(state_dtype=state_dtype)
    js = jopt.init_opt_state(p, jopt.OptimizerConfig(**cfg))
    ts = topt.init_opt_state(_torch(p), topt.OptimizerConfig(**cfg))
    for g, w in zip(topt.leaves(ts), jax.tree.leaves(js)):
        assert g.dtype == getattr(torch, str(w.dtype))
        assert tuple(g.shape) == w.shape and not bool(g.any())
