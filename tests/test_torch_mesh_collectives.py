"""The port's collectives over named axes (``dist.Mesh``) against the JAX
package's ``shard_map`` collectives on a (pod 2, data 2, model 2) mesh of
8 host devices, along every axis and tuple of axes; their gradients
against the same function written unsharded; the same collectives over
``torch.distributed`` (gloo, four processes) against the one-process
baton; ``allreduce_int8`` over 8 ranks and ``pipeline_apply`` over 4
against JAX's.

Tolerances: gathers, all-to-alls, permutations, maxima and the index are
exact; sums are summed in another order (1e-6 relative); the int8
all-reduce within one f32 ulp at the scale of the mean, its error feedback
within one ulp at the input's (``quantize`` itself is bit-equal, in
``test_torch_mesh_rules.py``); the pipeline 2e-5 (the JAX test's).
"""
import os
import tempfile

import numpy as np
import pytest
import torch

from repro_torch import dist
from repro_torch.parallel import compress as tcompress
from repro_torch.parallel import pipeline as tpipe

from _torch_mesh import run_jax

SHAPE, AXES = (2, 2, 2), ("pod", "data", "model")
AXIS_SETS = ("pod", "data", "model", ("pod", "data"), ("data", "model"),
             ("pod", "model"), ("model", "pod"), ("pod", "data", "model"))
OPS = ("all_gather0", "all_gather1", "psum", "pmax", "pmean", "all_to_all",
       "all_to_all10", "psum_scatter", "ppermute", "axis_index")


def _name(axes):
    return axes if isinstance(axes, str) else "+".join(axes)


def _inputs():
    rng = np.random.default_rng(0)
    return rng.normal(size=(8, 8, 4)).astype(np.float32)   # (rank, 8, 4)


JAX_CODE = """
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro.compat import shard_map
from repro.launch.mesh import make_mesh
from repro.parallel.compress import allreduce_int8
from repro.parallel.pipeline import pipeline_apply
AXIS_SETS, OPS, SHAPE, AXES = @CONSTS@
_name = lambda a: a if isinstance(a, str) else "+".join(a)
mesh = make_mesh(SHAPE, AXES)
x = jnp.asarray(np.random.default_rng(0).normal(size=(8, 8, 4)).astype(
    np.float32).reshape(64, 4))                  # _inputs()
ALL = ("pod", "data", "model")
out = {}

def op(name, axes, xl):
    n = 1
    for a in (axes if isinstance(axes, tuple) else (axes,)):
        n *= mesh.shape[a]
    if name == "all_gather0":
        return jax.lax.all_gather(xl, axes, axis=0, tiled=True)
    if name == "all_gather1":
        return jax.lax.all_gather(xl, axes, axis=1, tiled=True)
    if name == "psum":
        return jax.lax.psum(xl, axes)
    if name == "pmax":
        return jax.lax.pmax(xl, axes)
    if name == "pmean":
        return jax.lax.pmean(xl, axes)
    if name == "all_to_all":
        return jax.lax.all_to_all(xl, axes, 0, 0, tiled=True)
    if name == "all_to_all10":
        return jax.lax.all_to_all(xl, axes, 0, 1, tiled=True)
    if name == "psum_scatter":
        return jax.lax.psum_scatter(xl, axes, scatter_dimension=0,
                                    tiled=True)
    if name == "ppermute":
        return jax.lax.ppermute(xl, axes, [(i, (i + 1) % n)
                                           for i in range(n)])
    return jnp.full((1, 1), jax.lax.axis_index(axes), jnp.float32)

keys = [(name, axes) for name in OPS for axes in AXIS_SETS]
f = shard_map(lambda xl: tuple(op(n, a, xl) for n, a in keys), mesh=mesh,
              in_specs=(P(ALL),), out_specs=tuple(P(ALL) for _ in keys),
              check_vma=False)
for (name, axes), y in zip(keys, jax.jit(f)(x)):     # one compile
    out[f"{name}|{_name(axes)}"] = np.asarray(y)

# allreduce_int8 over an 8-way pod axis
pmesh = make_mesh((8,), ("pod",))
rng = np.random.default_rng(1)
xi = jnp.asarray(rng.normal(size=(8, 128)).astype(np.float32))
ei = jnp.asarray((rng.normal(size=(8, 128)) * 1e-3).astype(np.float32))
def body(xl, el):
    red, err = allreduce_int8(xl[0], el[0], "pod")
    return red[None], err[None]
red, err = jax.jit(shard_map(body, mesh=pmesh, in_specs=(P("pod"), P("pod")),
                             out_specs=(P("pod"), P("pod")),
                             check_vma=False))(xi, ei)
out["int8_x"], out["int8_e"] = np.asarray(xi), np.asarray(ei)
out["int8_red"], out["int8_err"] = np.asarray(red), np.asarray(err)

# pipeline_apply over a 4-way stage axis
smesh = make_mesh((4,), ("stage",))
L, d = 8, 16
w = jnp.asarray(rng.normal(size=(L, d, d)).astype(np.float32) * 0.2)
xs = jnp.asarray(rng.normal(size=(6, 3, d)).astype(np.float32))
def layer_fn(lp, h):
    return jnp.tanh(h @ lp["w"])
out["pipe_w"], out["pipe_x"] = np.asarray(w), np.asarray(xs)
out["pipe_out"] = np.asarray(pipeline_apply(layer_fn, {"w": w}, xs, smesh,
                                            axis="stage"))
np.savez(OUT, **out)
""".replace("@CONSTS@", repr((AXIS_SETS, OPS, SHAPE, AXES)))


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("mesh") / "collectives.npz")
    return run_jax(JAX_CODE, path)


def _port_op(c, name, axes, x):
    n = c.axis_size(axes)
    if name == "all_gather0":
        return c.all_gather(x, axes, 0)
    if name == "all_gather1":
        return c.all_gather(x, axes, 1)
    if name == "psum":
        return c.psum(x, axes)
    if name == "pmax":
        return c.pmax(x, axes)
    if name == "pmean":
        return c.pmean(x, axes)
    if name == "all_to_all":
        return c.all_to_all(x, axes, 0, 0)
    if name == "all_to_all10":
        return c.all_to_all(x, axes, 0, 1)
    if name == "psum_scatter":
        return c.psum_scatter(x, axes, 0)
    if name == "ppermute":
        return c.ppermute(x, axes, [(i, (i + 1) % n) for i in range(n)])
    return torch.full((1, 1), float(c.axis_index(axes)))


@pytest.mark.parametrize("axes", AXIS_SETS, ids=_name)
@pytest.mark.parametrize("name", OPS)
def test_collective_equals_jax(ref, name, axes):
    x = torch.from_numpy(_inputs())
    mesh = dist.LocalMesh(SHAPE, AXES)
    got = mesh.run(lambda c: _port_op(c, name, axes, x[c.rank]))
    want = ref[f"{name}|{_name(axes)}"]
    want = want.reshape((8, -1) + want.shape[1:])
    for r in range(8):
        np.testing.assert_allclose(got[r].numpy(), want[r], rtol=1e-6,
                                   atol=1e-6)


def _unsharded(name, axes, xs, mesh):
    """Every rank's result of the collective written with plain tensor
    ops on the ranks' inputs (``xs``: a list in rank order)."""
    if name == "ppermute":          # positions in the mesh's axis order
        names = (axes,) if isinstance(axes, str) else axes
        axes = tuple(a for a in mesh.axis_names if a in names)
    out = []
    for r in range(mesh.size):
        line = mesh.line(r, axes)
        me = line.index(r)
        parts = [xs[q] for q in line]
        n = len(line)
        if name == "all_gather0":
            y = torch.cat(parts, 0)
        elif name == "all_gather1":
            y = torch.cat(parts, 1)
        elif name in ("psum", "pmean"):
            y = sum(parts[1:], parts[0]) / (n if name == "pmean" else 1)
        elif name == "all_to_all":
            y = torch.cat([p.chunk(n, 0)[me] for p in parts], 0)
        elif name == "all_to_all10":
            y = torch.cat([p.chunk(n, 0)[me] for p in parts], 1)
        elif name == "psum_scatter":
            y = sum(parts[1:], parts[0]).chunk(n, 0)[me]
        else:                                    # ppermute
            y = parts[(me - 1) % n]
        out.append(y)
    return out


@pytest.mark.parametrize("axes", AXIS_SETS[:4] + AXIS_SETS[6:], ids=_name)
@pytest.mark.parametrize("name", [o for o in OPS
                                  if o not in ("pmax", "axis_index")])
def test_collective_grad_equals_unsharded(name, axes):
    """One backward over every rank's loss sum(c_r * op(x)_r), seeded
    1 / 8, against autograd of the same function written unsharded."""
    rng = np.random.default_rng(2)
    x0 = [torch.from_numpy(rng.normal(size=(8, 4)).astype(np.float32))
          for _ in range(8)]
    mesh = dist.LocalMesh(SHAPE, AXES)
    ref_x = [x.clone().requires_grad_(True) for x in x0]
    ys = _unsharded(name, axes, ref_x, mesh)
    cs = [torch.from_numpy(rng.normal(size=tuple(y.shape)).astype(
        np.float32)) for y in ys]
    total = sum((c * y).sum() for c, y in zip(cs, ys)) / 8
    total.backward()
    xs = [x.clone().requires_grad_(True) for x in x0]
    losses = mesh.run(lambda c: (cs[c.rank] * _port_op(
        c, name, axes, xs[c.rank])).sum())
    dist.backward_ranks(losses, 1.0 / 8)
    for a, b in zip(xs, ref_x):
        np.testing.assert_allclose(a.grad.numpy(), b.grad.numpy(), rtol=1e-6,
                                   atol=1e-6)


def test_ranks_at_different_ops_raise():
    mesh = dist.LocalMesh((2, 2), ("data", "model"))

    def body(c):
        x = torch.ones(2)
        return c.psum(x, "data") if c.rank == 0 else c.pmax(x, "data")
    with pytest.raises(RuntimeError, match="different collectives"):
        mesh.run(body)


def _proc_main(rank, path, port):
    import torch.distributed as tdist
    tdist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                             world_size=4, rank=rank)
    try:
        mesh = dist.ProcessMesh((2, 2), ("data", "model"))
        comm = mesh.comm(rank)
        x = torch.from_numpy(_inputs()[rank, :, :]).requires_grad_(True)
        outs = {}
        loss = 0
        for name in OPS:
            for axes in ("data", "model", ("data", "model"),
                         ("model", "data")):
                y = _port_op(comm, name, axes, x)
                outs[f"{name}|{_name(axes)}"] = y.detach().numpy()
                if name not in ("pmax", "axis_index"):
                    loss = loss + (y * (1 + torch.arange(
                        y.numel()).reshape(y.shape) % 3)).sum()
        (loss / 4).backward()
        outs["grad"] = x.grad.numpy()
        np.savez(f"{path}.{rank}.npz", **outs)
    finally:
        tdist.destroy_process_group()


def test_process_mesh_gloo_equals_local():
    """The process transport (one ``new_group`` a line, gloo, four
    processes) gives every collective and the gradient the baton gives."""
    import socket
    import torch.multiprocessing as mp
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    path = os.path.join(tempfile.mkdtemp(), "proc")
    mp.start_processes(_proc_main, args=(path, port), nprocs=4,
                       start_method="spawn", join=True)
    mesh = dist.LocalMesh((2, 2), ("data", "model"))
    xs = [torch.from_numpy(_inputs()[r]).requires_grad_(True)
          for r in range(4)]

    def body(c):
        outs, loss = {}, 0
        for name in OPS:
            for axes in ("data", "model", ("data", "model"),
                         ("model", "data")):
                y = _port_op(c, name, axes, xs[c.rank])
                outs[f"{name}|{_name(axes)}"] = y.detach().numpy()
                if name not in ("pmax", "axis_index"):
                    loss = loss + (y * (1 + torch.arange(
                        y.numel()).reshape(y.shape) % 3)).sum()
        return outs, loss
    res = mesh.run(body)
    dist.backward_ranks([r[1] for r in res], 1.0 / 4)
    for r in range(4):
        with np.load(f"{path}.{r}.npz") as f:
            for k, v in res[r][0].items():
                np.testing.assert_allclose(f[k], v, rtol=1e-6, atol=1e-6,
                                           err_msg=k)
            np.testing.assert_allclose(f["grad"], xs[r].grad.numpy(),
                                       rtol=1e-6, atol=1e-6)


def test_allreduce_int8_equals_jax(ref):
    mesh = dist.LocalMesh((8,), ("pod",))
    x, e = torch.from_numpy(ref["int8_x"]), torch.from_numpy(ref["int8_e"])
    got = mesh.run(lambda c: tcompress.allreduce_int8(
        x[c.rank], e[c.rank], "pod", c))
    for r in range(8):
        # one f32 ulp at the mean's scale (XLA sums the eight products in
        # an order of its own)
        ulp = float(np.spacing(np.abs(ref["int8_red"][r]).max()))
        np.testing.assert_allclose(got[r][0].numpy(), ref["int8_red"][r],
                                   rtol=0, atol=ulp)
        # the error feedback xf - q * scale: XLA contracts it into one
        # fused multiply-add under jit, so within one ulp of xf's scale
        xf_ulp = float(np.spacing(np.abs(ref["int8_x"][r]).max()))
        np.testing.assert_allclose(got[r][1].numpy(), ref["int8_err"][r],
                                   rtol=0, atol=xf_ulp)
    exact = ref["int8_x"].mean(0)
    rel = np.abs(got[0][0].numpy() - exact).max() / np.abs(exact).max()
    assert rel < 0.05, rel


def test_pipeline_apply_equals_jax(ref):
    mesh = dist.LocalMesh((4,), ("stage",))
    w = torch.from_numpy(ref["pipe_w"])
    xs = torch.from_numpy(ref["pipe_x"])
    got = mesh.run(lambda c: tpipe.pipeline_apply(
        lambda lp, h: torch.tanh(h @ lp["w"]), {"w": w}, xs, c,
        axis="stage"))
    seq = xs
    for i in range(w.shape[0]):
        seq = torch.tanh(seq @ w[i])
    for g in got:
        np.testing.assert_allclose(g.numpy(), ref["pipe_out"], rtol=2e-5,
                                   atol=2e-5)
        np.testing.assert_allclose(g.numpy(), seq.numpy(), rtol=2e-5,
                                   atol=2e-5)
