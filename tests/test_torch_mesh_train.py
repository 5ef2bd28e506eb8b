"""The whole slice on a mesh against the JAX package's (one JAX subprocess,
8 host devices, ``repro.launch.mesh.make_mesh``), on qwen2-7b's smoke
config in f32:

- the loss and every leaf's gradient under the ``tp`` layout (dense and
  vocab-parallel loss) and the ``fsdp`` layout on a (data 2, model 2)
  mesh, against JAX's mesh loss and gradients within 2e-3 (relative to
  each leaf's largest gradient; JAX cannot differentiate its
  vocab-parallel loss, ``jax.lax.pmax`` having no differentiation rule, so
  that case's gradients are held to JAX's dense ones, the same function);
  the port's weights held whole by the rule
  (the smoke widths are under its threshold) and split on every leaf (a
  threshold of 0, so the column-, row- and vocab-parallel paths run);
- the Delta-periodic sync on a (pod 2, data 2, model 2) mesh: at Delta = 1
  equal to JAX's direct mesh step within 2e-5 (the JAX package's own
  test's bound; JAX's partial-manual pod accumulate aborts XLA on this
  toolchain, so its direct step is the reference), and at Delta = 4 equal
  to JAX's no-pod ``make_periodic_steps`` within 2e-5;
- ``remesh_restore``: a state saved from (2, 2) and restored onto (1, 2),
  every leaf bitwise, and a train step on the new mesh; restored onto
  (2, 2, 2), m and v with the specs of JAX's optimizer-state rule
  (``make_param_shardings(opt_state=True)``);
- ZeRO across pods on (pod 2, data 2, model 2), every leaf split: m and v
  placed by that rule hold half the params' blocks, and two train steps
  at lr 3e-4 equal JAX's train step jitted with those shardings (the
  params within 2e-5 absolute, m and v each leaf within 2e-3 of its
  largest value);
- remat on the baton: ``full`` and ``dots_saveable`` give the loss and
  every gradient bitwise ``none``'s, each layer's forward run twice.
"""
import json

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import manager
from repro_torch.configs import get_smoke_config as tget
from repro_torch.launch import steps as tsteps
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import build_model
from repro_torch.models import transformer as tfm
from repro_torch.optim import optimizer as topt
from repro_torch.optim import periodic as tperiodic
from repro_torch.optim.optimizer import leaves
from repro_torch.parallel import sharding as shd
from repro_torch.runtime import elastic as telastic

from _torch_mesh import F32_TOL, run_jax_side_by_side

CASES = {"tp": ("tp", "dense"), "fsdp": ("fsdp", "dense"),
         "tp_vocab_parallel": ("tp", "vocab_parallel")}
AXES3 = ("pod", "data", "model")

JAX_CODE = """
import numpy as np, jax, jax.numpy as jnp
from repro.configs import get_smoke_config
from repro.models import build_model
from repro.optim.optimizer import OptimizerConfig, adamw_update, \\
    init_opt_state
from repro.optim.periodic import init_accumulator, init_error, \\
    make_periodic_steps
from repro.parallel import sharding as shd
from repro.launch.mesh import make_mesh
from _torch_mesh import flat_names
CASES = %r
out = {}
rng = np.random.default_rng(5)
cfg = get_smoke_config("qwen2-7b").replace(dtype="float32")
params = build_model(cfg).init(jax.random.key(0))
for name, leaf in flat_names(jax.device_get(params)):
    out["p/" + name] = np.asarray(leaf)
toks = rng.integers(0, cfg.vocab_size, (5, 8, 32)).astype(np.int32)
out["tokens"] = toks
batch = {"tokens": jnp.asarray(toks[0])}
mesh = make_mesh((2, 2), ("data", "model"))
for case, (layout, ce) in CASES.items():
    c = cfg.replace(parallel=cfg.parallel.replace(layout=layout, ce_mode=ce))
    api = build_model(c)
    def lf(p):
        with shd.use_mesh(mesh, layout):
            return api.loss(p, batch, mesh)[0]
    if ce == "vocab_parallel":   # pmax has no differentiation rule
        out[case + "/loss"] = np.asarray(jax.jit(lf)(params))
        continue
    loss, g = jax.jit(jax.value_and_grad(lf))(params)
    out[case + "/loss"] = np.asarray(loss)
    for i, leaf in enumerate(jax.tree.leaves(g)):
        out[f"{case}/g{i}"] = np.asarray(leaf)
api = build_model(cfg)
opt_cfg = OptimizerConfig(grad_clip=0.0, warmup_steps=0)
opt = init_opt_state(params, opt_cfg)
# Delta = 1: the direct step on (pod 2, data 2, model 2)
mesh3 = make_mesh((2, 2, 2), ("pod", "data", "model"))
def lf3(p):
    with shd.use_mesh(mesh3):
        return api.loss(p, batch, mesh3)[0]
g = jax.jit(jax.grad(lf3))(params)
p1, _, _ = adamw_update(params, g, opt, opt_cfg)
for i, leaf in enumerate(jax.tree.leaves(p1)):
    out[f"delta1/{i}"] = np.asarray(leaf)
# Delta = 4: the no-pod periodic steps on (data 2, model 2)
accum, sync = make_periodic_steps(api, mesh, opt_cfg)
acc, err = init_accumulator(params, mesh), init_error(params, mesh)
for i in range(1, 5):
    acc, _ = accum(params, acc, {"tokens": jnp.asarray(toks[i])})
p4, _, _, _, _ = sync(params, opt, acc, err)
for i, leaf in enumerate(jax.tree.leaves(p4)):
    out[f"delta4/{i}"] = np.asarray(leaf)
np.savez(OUT, **out)
""" % (CASES,)

# ZeRO's reference runs beside JAX_CODE, in a process of its own: the same
# params and tokens (the first draws of the same seeds)
ZERO_CODE = """
import json
import numpy as np, jax, jax.numpy as jnp
from repro.configs import get_smoke_config
from repro.launch.mesh import make_mesh
from repro.launch.steps import make_train_step, opt_config_for
from repro.models import build_model
from repro.optim.optimizer import init_opt_state
from repro.parallel import sharding as shd
out = {}
rng = np.random.default_rng(5)
cfg = get_smoke_config("qwen2-7b").replace(dtype="float32")
api = build_model(cfg)
params = api.init(jax.random.key(0))
toks = rng.integers(0, cfg.vocab_size, (5, 8, 32)).astype(np.int32)
mesh3 = make_mesh((2, 2, 2), ("pod", "data", "model"))
# ZeRO across pods: the train step jitted with m and v sharded by the
# optimizer-state rule, as JAX's dry run shards them, on (pod 2, data 2,
# model 2) with every leaf split; two steps at the pod sync's lr with no
# warm-up, so the params move by ~lr a step
shd._REPLICATE_BELOW = 0
ocfg = opt_config_for(cfg).replace(lr=3e-4, warmup_steps=0)
pshard = shd.make_param_shardings(params, mesh3)
oshard = {k: shd.make_param_shardings(params, mesh3, opt_state=True)
          for k in ("m", "v")}
oshard["step"] = shd.replicated(mesh3)
zstep = jax.jit(make_train_step(api, mesh3, ocfg),
                in_shardings=(pshard, oshard, {"tokens": shd.batch_sharding(
                    mesh3, 2, batch_size=toks.shape[1])}),
                out_shardings=(pshard, oshard, None))
zp, zo = params, init_opt_state(params, ocfg)
for i in range(2):
    zp, zo, _ = zstep(zp, zo, {"tokens": jnp.asarray(toks[i])})
for name, tree in (("p", zp), ("m", zo["m"]), ("v", zo["v"])):
    for i, leaf in enumerate(jax.tree.leaves(tree)):
        out[f"zero/{name}{i}"] = np.asarray(leaf)
out["zero/specs"] = np.array(json.dumps([
    [list(e) if isinstance(e, tuple) else e for e in s.spec]
    for s in jax.tree.leaves(oshard["m"])]))
np.savez(OUT, **out)
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh")
    return run_jax_side_by_side([(JAX_CODE, str(tmp / "train.npz")),
                                 (ZERO_CODE, str(tmp / "zero.npz"))])


def _params(ref):
    out = {}
    for key, arr in ref.items():
        if key.startswith("p/"):
            node, parts = out, key[2:].split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = torch.from_numpy(arr.copy())
    out["layers"] = [out["layers"][str(i)] for i in range(len(out["layers"]))]
    return out


def _close(got, want, tol, what):
    assert len(got) == len(want), what
    for i, (g, w) in enumerate(zip(got, want)):
        g = g.detach().float().numpy()
        assert g.shape == w.shape, (what, i)
        err = float(np.abs(g - w).max())
        assert err <= tol * max(float(np.abs(w).max()), 1.0), (what, i, err)


def _mesh_grads(api, sp, mesh, batch):
    """(the ranks' losses, every leaf's gradient assembled whole)."""
    outs = mesh.run(lambda c: tsteps.rank_loss(api, c, sp, batch))
    tsteps.mesh_backward(mesh.size, outs)
    grads = mesh.run(lambda c: tsteps.take_grads(c, sp))
    whole = [shd.Sharded([grads[r][i] for r in range(mesh.size)], p.spec,
                         p.shape, mesh).full()
             for i, p in enumerate(leaves(sp))]
    return [float(o[0]) for o in outs], whole


@pytest.mark.parametrize("threshold", [None, 0])
@pytest.mark.parametrize("case", list(CASES))
def test_loss_and_grads_equal_jax(ref, case, threshold, monkeypatch):
    if threshold is not None:
        monkeypatch.setattr(shd, "_REPLICATE_BELOW", threshold)
    layout, ce = CASES[case]
    cfg = tget("qwen2-7b").replace(dtype="float32")
    cfg = cfg.replace(parallel=cfg.parallel.replace(layout=layout,
                                                    ce_mode=ce))
    api = build_model(cfg)
    mesh = make_mesh((2, 2), ("data", "model"))
    sp = shd.shard_params(_params(ref), mesh, layout=layout)
    if threshold == 0:
        assert all(p.spec != () for p in leaves(sp) if p.dim() >= 2)
    losses, grads = _mesh_grads(api, sp, mesh,
                                {"tokens": torch.from_numpy(ref["tokens"][0])})
    for loss in losses:
        np.testing.assert_allclose(loss, ref[case + "/loss"], rtol=F32_TOL,
                                   atol=F32_TOL)
    # JAX cannot differentiate its vocab-parallel loss (jax.lax.pmax has
    # no differentiation rule); it equals the dense one, whose gradients
    # are the reference
    src = "tp" if ce == "vocab_parallel" else case
    want = [ref[f"{src}/g{i}"] for i in range(len(grads))]
    _close(grads, want, F32_TOL, case)


def _pod_run(ref, steps):
    cfg = tget("qwen2-7b").replace(dtype="float32")
    api = build_model(cfg)
    mesh = make_mesh((2, 2, 2), ("pod", "data", "model"))
    opt_cfg = topt.OptimizerConfig(grad_clip=0.0, warmup_steps=0)
    sp = shd.shard_params(_params(ref), mesh)
    opt = topt.init_opt_state(sp, opt_cfg)
    acc = tperiodic.init_accumulator(sp, mesh)
    err = tperiodic.init_error(sp, mesh)
    accum, sync = tperiodic.make_periodic_steps(api, mesh, opt_cfg)
    for i in steps:
        acc, m = accum(sp, acc, {"tokens": torch.from_numpy(
            ref["tokens"][i])})
        assert np.isfinite(float(m["loss"]))
    sp, opt, acc, err, _ = sync(sp, opt, acc, err)
    assert int(opt["step"]) == 1
    assert all(float(a.abs().max()) == 0 for a in leaves(shd.unshard(acc)))
    return leaves(shd.unshard(sp))


def test_pod_sync_delta_1_equals_jax_direct_step(ref):
    got = _pod_run(ref, [0])
    want = [ref[f"delta1/{i}"] for i in range(len(got))]
    for g, w in zip(got, want):
        assert float(np.abs(g.numpy() - w).max()) < 2e-5


def test_pod_sync_delta_4_equals_jax_no_pod(ref):
    got = _pod_run(ref, [1, 2, 3, 4])
    want = [ref[f"delta4/{i}"] for i in range(len(got))]
    for g, w in zip(got, want):
        assert float(np.abs(g.numpy() - w).max()) < 2e-5


def test_remesh_restore_bitwise(ref, tmp_path, monkeypatch):
    """A (2, 2) state with every leaf split, saved whole and restored onto
    a (1, 2) mesh: every leaf bitwise; a train step runs there."""
    monkeypatch.setattr(shd, "_REPLICATE_BELOW", 0)
    cfg = tget("qwen2-7b").replace(dtype="float32")
    api = build_model(cfg)
    opt_cfg = tsteps.opt_config_for(cfg)
    mesh = make_mesh((2, 2), ("data", "model"))
    sp = shd.shard_params(_params(ref), mesh)
    opt = topt.init_opt_state(sp, opt_cfg)
    batch = {"tokens": torch.from_numpy(ref["tokens"][0])}
    sp, opt, _ = tsteps.make_train_step(api, mesh, opt_cfg)(sp, opt, batch)
    manager.save(str(tmp_path), 7, {"params": sp, "opt": opt})
    new = make_mesh((1, 2), ("data", "model"))
    step, tree, specs = telastic.remesh_restore(
        str(tmp_path), {"params": sp, "opt": opt}, new)
    assert step == 7
    for a, b in zip(leaves(shd.unshard({"params": sp, "opt": opt})),
                    leaves(shd.unshard(tree))):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert any(p.spec != () for p in leaves(tree["params"]))
    _, opt2, m = tsteps.make_train_step(api, new, opt_cfg)(
        tree["params"], tree["opt"], batch)
    assert np.isfinite(float(m["loss"])) and int(opt2["step"]) == 2
    # onto a mesh with pod: m and v by JAX's optimizer-state rule
    new3 = make_mesh((2, 2, 2), AXES3)
    step, tree3, _ = telastic.remesh_restore(
        str(tmp_path), {"params": sp, "opt": opt}, new3)
    want = json.loads(str(ref["zero/specs"]))
    for k in ("m", "v"):
        got = leaves(tree3["opt"][k])
        assert len(got) == len(want)
        for x, w in zip(got, want):
            assert _axes_of(x.spec, x.dim()) == _axes_of(w, x.dim())
    assert any(m.spec != p.spec for m, p in zip(leaves(tree3["opt"]["m"]),
                                                leaves(tree3["params"])))
    for a, b in zip(leaves(shd.unshard({"params": sp, "opt": opt})),
                    leaves(shd.unshard(tree3))):
        assert a.dtype == b.dtype and torch.equal(a, b)
    _, opt3, m = tsteps.make_train_step(api, new3, opt_cfg)(
        tree3["params"], tree3["opt"], batch)
    assert np.isfinite(float(m["loss"])) and int(opt3["step"]) == 2


def _axes_of(spec, ndim):
    """A spec (the port's ``P`` or JAX's as a list) as one tuple of axes a
    dim."""
    spec = list(spec) + [None] * (ndim - len(spec))
    return tuple(() if e is None else (e,) if isinstance(e, str) else
                 tuple(e) for e in spec)


def _zero_state(ref):
    """qwen2-7b's smoke model in f32 on (2, 2, 2): the params by their
    rule, m and v by the optimizer-state rule; the config's optimizer at
    the pod sync tests' lr, 3e-4, from the first step."""
    cfg = tget("qwen2-7b").replace(dtype="float32")
    api = build_model(cfg)
    ocfg = tsteps.opt_config_for(cfg).replace(lr=3e-4, warmup_steps=0)
    mesh = make_mesh((2, 2, 2), AXES3)
    params = _params(ref)
    sp = shd.shard_params(params, mesh)
    opt = topt.shard_opt_state(topt.init_opt_state(params, ocfg), mesh)
    return api, ocfg, mesh, sp, opt


def test_zero_m_and_v_half_the_params_blocks(ref, monkeypatch):
    """Every leaf split by the data axis has m and v split over pod too
    (JAX's specs), each rank's blocks half its param block; the others are
    held as the param."""
    monkeypatch.setattr(shd, "_REPLICATE_BELOW", 0)
    _, _, mesh, sp, opt = _zero_state(ref)
    want = json.loads(str(ref["zero/specs"]))
    split = 0
    for p, m, v, w in zip(leaves(sp), leaves(opt["m"]), leaves(opt["v"]),
                          want):
        assert _axes_of(m.spec, m.dim()) == _axes_of(w, m.dim())
        assert v.spec == m.spec
        zero = "data" in {a for e in _axes_of(p.spec, p.dim()) for a in e}
        assert (m.spec != p.spec) == zero
        split += zero
        for r in range(mesh.size):
            assert m.local(r).numel() * (2 if zero else 1) == \
                p.local(r).numel()
            assert v.local(r).shape == m.local(r).shape
    assert split >= 8


def test_zero_train_steps_equal_jax(ref, monkeypatch):
    """Two train steps with m and v split over pod (the gradient
    reduce-scattered over pod to m's block, the param gathered back)
    against JAX's step jitted with the optimizer-state shardings, at lr
    3e-4 from the first step: the params within 2e-5 absolute (the pod
    sync's tolerance), each leaf having moved by 5e-4 or more in JAX, so a
    block of the update not written back shows; m and v each within 2e-3
    of the leaf's largest value."""
    monkeypatch.setattr(shd, "_REPLICATE_BELOW", 0)
    api, ocfg, mesh, sp, opt = _zero_state(ref)
    p0 = [x.numpy().copy() for x in leaves(_params(ref))]
    step = tsteps.make_train_step(api, mesh, ocfg)
    for i in range(2):
        sp, opt, m = step(sp, opt, {"tokens": torch.from_numpy(
            ref["tokens"][i])})
        assert np.isfinite(float(m["loss"]))
    assert int(opt["step"]) == 2
    for name, tree in (("p", sp), ("m", opt["m"]), ("v", opt["v"])):
        for i, x in enumerate(leaves(tree)):
            w = ref[f"zero/{name}{i}"]
            got = x.full().numpy()
            assert got.shape == w.shape, (name, i)
            err = float(np.abs(got - w).max())
            if name == "p":
                assert float(np.abs(w - p0[i]).max()) >= 5e-4, i
                assert err < 2e-5, (name, i, err)
            else:
                assert err <= F32_TOL * float(np.abs(w).max()), (name, i, err)


def _remat_grads(ref, mode):
    """(the ranks' losses, every gradient, the layer forwards run) of
    qwen2-7b's smoke model in f32 on a (2, 2, 2) ``LocalMesh`` under remat
    ``mode``, every leaf split."""
    calls = []
    real = tfm.apply_layer_full

    def counted(*a, **kw):
        calls.append(1)
        return real(*a, **kw)
    base = tget("qwen2-7b").replace(dtype="float32")
    cfg = base.replace(parallel=base.parallel.replace(remat=mode))
    mesh = make_mesh((2, 2, 2), AXES3)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(shd, "_REPLICATE_BELOW", 0)
        mp.setattr(tfm, "apply_layer_full", counted)
        losses, grads = _mesh_grads(
            build_model(cfg), shd.shard_params(_params(ref), mesh), mesh,
            {"tokens": torch.from_numpy(ref["tokens"][0])})
    return losses, grads, len(calls)


@pytest.fixture(scope="module")
def remat_none(ref):
    return _remat_grads(ref, "none")


@pytest.mark.parametrize("mode", ["full", "dots_saveable"])
def test_remat_on_the_baton_bitwise_none(ref, remat_none, mode):
    """qwen2-7b's smoke model in f32 on a (2, 2, 2) ``LocalMesh``, every
    leaf split: under ``mode`` the ranks' losses and every gradient are
    bitwise ``remat='none'``'s, and each layer's forward runs twice a rank
    (the recompute, every rank's together behind the baton)."""
    losses, grads, calls = _remat_grads(ref, mode)
    assert losses == remat_none[0]
    assert all(torch.equal(a, b) for a, b in zip(grads, remat_none[1]))
    assert remat_none[2] == 8 * tget("qwen2-7b").num_layers
    assert calls == 2 * remat_none[2]


@pytest.mark.parametrize("shape", [None, (1, 2)])
def test_remat_on_the_baton_refuses_other_modes(ref, shape):
    """A remat mode other than 'none', 'full' and 'dots_saveable' raises,
    on a ``LocalMesh`` as without a mesh: the layers never keep their
    activations quietly, nor recompute them under a mode they do not
    know."""
    cfg = tget("qwen2-7b").replace(dtype="float32")
    cfg = cfg.replace(parallel=cfg.parallel.replace(remat="offload"))
    api = build_model(cfg)
    params = _params(ref)
    batch = {"tokens": torch.from_numpy(ref["tokens"][0])}
    with pytest.raises(ValueError, match="remat='offload'"):
        if shape is None:
            tsteps.loss_and_grads(api, params, batch)
        else:
            mesh = make_mesh(shape, ("data", "model"))
            _mesh_grads(api, shd.shard_params(params, mesh), mesh, batch)
