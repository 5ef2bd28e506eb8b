"""The port's train step, periodic sync and TrainingRunner against the JAX
package's, on the f32 qwen2-7b smoke model.

Losses of three train steps from the same params, optimizer state and
batches agree within 2e-3 (each package steps from its own gradients, so
the params drift apart by about lr where a gradient is near 0: only the
losses are compared). ``optim.periodic`` with Delta = 1 equals the direct
step within 2e-5 (the assertion of the JAX package's
``test_periodic_sync_equals_direct_when_delta_1``, without its 8-device
mesh); with Delta = 4 its accumulator matches the JAX no-pod
``make_periodic_steps``'s within 2e-3 of each leaf's scale, and the sync
on JAX's accumulator gives JAX's params within 4 f32 ulps of the leaf's
scale (the runner: ``test_torch_train_runner.py``)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_lm import F32_TOL
from _torch_train import assert_grads_close, both
from repro.launch import steps as jsteps
from repro.launch.mesh import make_mesh
from repro.optim import optimizer as jopt
from repro.optim import periodic as jperiodic
from repro_torch import convert
from repro_torch.data.pipeline import DataConfig, TokenPipeline
from repro_torch.launch import steps as tsteps
from repro_torch.optim import optimizer as topt
from repro_torch.optim import periodic as tperiodic
from repro_torch.optim.optimizer import leaves

OPT = dict(lr=1e-3, warmup_steps=2, total_steps=20)


def _mesh():
    return make_mesh((1, 1), ("data", "model"))


def _batches(cfg, n, start=0):
    data = TokenPipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=16,
                                    global_batch=2, seed=4),
                         start_step=start, device="cpu")
    out = [next(data)["tokens"] for _ in range(n)]
    data.close()
    return out


def test_three_train_steps_match_jax():
    japi, tapi, jp, tp, _, _ = both("qwen2-7b")
    jcfg, tcfg = jopt.OptimizerConfig(**OPT), topt.OptimizerConfig(**OPT)
    jo, to = jopt.init_opt_state(jp, jcfg), topt.init_opt_state(tp, tcfg)
    jstep = jax.jit(jsteps.make_train_step(japi, _mesh(), jcfg))
    tstep = tsteps.make_train_step(tapi, None, tcfg)
    for toks in _batches(tapi.cfg, 3):
        jp, jo, jm = jstep(jp, jo, {"tokens": jnp.asarray(toks.numpy())})
        tp, to, tm = tstep(tp, to, {"tokens": toks})
        for key in ("loss", "ce", "grad_norm"):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                       rtol=F32_TOL, atol=F32_TOL)
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]),
                                   rtol=1e-6)
    assert int(to["step"]) == 3
    assert all(p.grad is None for p in leaves(tp))


def test_periodic_sync_equals_direct_when_delta_1():
    _, tapi, _, tp, _, tb = both("qwen2-7b", batch=4, seq=32)
    cfg = topt.OptimizerConfig(grad_clip=0.0, warmup_steps=0)
    direct = {k: v for k, v in convert.lm_params_from_numpy(
        convert.lm_params_to_numpy(tp), device="cpu").items()}
    p_ref, _, _ = tsteps.make_train_step(tapi, None, cfg)(
        direct, topt.init_opt_state(direct, cfg), tb)
    accum, sync = tperiodic.make_periodic_steps(tapi, None, cfg)
    acc, err = tperiodic.init_accumulator(tp), tperiodic.init_error(tp)
    acc, metrics = accum(tp, acc, tb)
    assert np.isfinite(float(metrics["loss"]))
    p_new, _, acc, err, _ = sync(tp, topt.init_opt_state(tp, cfg), acc, err)
    d = max(float((a - b).detach().abs().max())
            for a, b in zip(leaves(p_ref), leaves(p_new)))
    assert d < 2e-5, d
    assert not any(bool(a.any()) for a in leaves(acc))


def test_periodic_delta_4_matches_jax_no_pod():
    japi, tapi, jp, tp, _, _ = both("qwen2-7b")
    kw = dict(OPT, grad_clip=1.0)
    jcfg, tcfg = jopt.OptimizerConfig(**kw), topt.OptimizerConfig(**kw)
    jaccum, jsync = jperiodic.make_periodic_steps(japi, _mesh(), jcfg)
    taccum, tsync = tperiodic.make_periodic_steps(tapi, None, tcfg)
    jacc = jperiodic.init_accumulator(jp, _mesh())
    tacc = tperiodic.init_accumulator(tp)
    for toks in _batches(tapi.cfg, 4):
        jacc, _ = jaccum(jp, jacc, {"tokens": jnp.asarray(toks.numpy())})
        tacc, _ = taccum(tp, tacc, {"tokens": toks})
    assert_grads_close(leaves(tacc), jax.tree.leaves(jacc), "accumulator")
    # the sync on shared inputs: JAX's accumulator carried across
    shared = convert.lm_params_from_numpy(jax.device_get(jacc), device="cpu")
    jo, to = jopt.init_opt_state(jp, jcfg), topt.init_opt_state(tp, tcfg)
    jp2, _, _, _, _ = jsync(jp, jo, jacc, jperiodic.init_error(jp, _mesh()))
    tp2, to2, _, _, _ = tsync(tp, to, shared, tperiodic.init_error(tp))
    assert int(to2["step"]) == 1
    for g, w in zip(leaves(tp2), jax.tree.leaves(jp2)):
        w = np.asarray(w)
        np.testing.assert_allclose(g.detach().numpy(), w, rtol=4 * 2.0 ** -23,
                                   atol=4 * 2.0 ** -23 * np.abs(w).max())


def test_periodic_refuses_a_mesh_and_int8():
    """The pod axis and its int8 sync (item 14f) run: on a (2, 1, 1) pod
    mesh the accumulator has the pods' leading axis, and a Delta = 1 sync,
    exact or int8, moves the params as the mesh-free step does (the int8
    one within 0.05 of the update's size); the mesh's train step runs."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.mesh import make_mesh as tmake_mesh
    from repro_torch.models import build_model
    from repro_torch.parallel import sharding as shd
    tapi = build_model(get_smoke_config("qwen2-7b").replace(dtype="float32"))
    tp = tapi.init(0, device="cpu")
    cfg = topt.OptimizerConfig(grad_clip=0.0, warmup_steps=0)
    batch = {"tokens": torch.cat(_batches(tapi.cfg, 2), 0)}
    mesh = tmake_mesh((2, 1, 1), ("pod", "data", "model"))
    ref_tree = shd._map_named(lambda _, x: x.detach().clone(), tp)
    tsteps.make_train_step(tapi, None, cfg)(
        ref_tree, topt.init_opt_state(ref_tree, cfg), batch)
    ref = [x.detach() for x in leaves(ref_tree)]
    from repro_torch.parallel import compress
    for int8 in (False, True):
        sp = shd.shard_params(tp, mesh)
        acc = tperiodic.init_accumulator(sp, mesh)
        assert all(a.shape[0] == 2 for a in leaves(acc))
        accum, sync = tperiodic.make_periodic_steps(tapi, mesh, cfg,
                                                    compress_int8=int8)
        acc, _ = accum(sp, acc, batch)
        if int8:    # the int8 mean of the pods' sums against the exact one
            def both(c):
                out = []
                for a in leaves(shd.local_tree(acc, c.rank)):
                    got, _ = compress.allreduce_int8(
                        a[0], torch.zeros_like(a[0]), "pod", c)
                    out.append((got, c.pmean(a[0], "pod")))
                return out
            for got, want in mesh.run(both)[0]:
                scale = float(want.abs().max())
                assert float((got - want).abs().max()) <= 0.05 * scale
        sp, opt, acc, _, _ = sync(sp, topt.init_opt_state(sp, cfg), acc,
                                  tperiodic.init_error(sp, mesh))
        assert int(opt["step"]) == 1
        for g, w in zip(leaves(shd.unshard(sp)), ref):
            assert bool(torch.isfinite(g).all())
            if not int8:
                assert float((g - w).abs().max()) <= 2e-5
    sp = shd.shard_params(tp, mesh)
    _, _, m = tsteps.make_train_step(tapi, mesh, cfg)(
        sp, topt.init_opt_state(sp, cfg), batch)
    assert np.isfinite(float(m["loss"]))


def test_prefill_and_decode_steps_run_without_grad():
    """``make_prefill_step`` / ``make_decode_step`` on params that require
    grad (as after a train step): the serving path under ``no_grad``, the
    same logits as ``api.prefill`` / ``api.decode_step``; a mesh raises."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import build_model
    api = build_model(get_smoke_config("qwen2-7b"))
    params = api.init(0, device="cpu")
    for p in leaves(params):
        p.requires_grad_(True)
    toks = _batches(api.cfg, 1)[0]
    logits, state = tsteps.make_prefill_step(api, None)(params,
                                                        {"tokens": toks})
    assert not logits.requires_grad
    with torch.no_grad():
        want, want_state = api.prefill(params, {"tokens": toks})
    assert torch.equal(logits, want)
    tok = torch.argmax(logits, -1).to(torch.int32)
    nxt, _ = tsteps.make_decode_step(api, None)(params, state, tok)
    with torch.no_grad():
        assert torch.equal(nxt, api.decode_step(params, want_state, tok)[0])
    assert not nxt.requires_grad
    # on a (1, 2) mesh: the same logits, the ranks' states
    from repro_torch.launch.mesh import make_mesh as tmake_mesh
    from repro_torch.parallel import sharding as shd
    mesh = tmake_mesh((1, 2), ("data", "model"))
    sp = shd.shard_params(params, mesh)
    got, states = tsteps.make_prefill_step(api, mesh)(sp, {"tokens": toks})
    assert not got.requires_grad and len(states) == 2
    assert torch.equal(got, want)
    # split-KV: the softmax partials merged across the two ranks (bf16)
    got, _ = tsteps.make_decode_step(api, mesh)(sp, states, tok)
    assert float((got.float() - nxt.float()).abs().max()) <= \
        2.0 ** -5 * float(nxt.float().abs().max())
