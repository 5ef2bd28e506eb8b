"""The port's sharding rules, mesh shapes and int8 quantizer against the JAX
package's, in the test process (pure logic; no collective runs):

- every case of ``tests/test_sharding_rules.py`` through the port's
  ``infer_param_spec`` and ``constrain``, and every leaf of every
  architecture's params on three meshes, both layouts, params and optimizer
  state, equal to JAX's ``infer_param_spec``;
- ``batch_sharding`` and the decode ``state_shardings`` equal to JAX's
  specs;
- ``best_mesh_shape`` equal to JAX's for n from 1 to 512;
- ``quantize`` bit-equal to JAX's (f32, round half to even), ties
  included.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

from repro.configs import ARCH_IDS as JARCH_IDS
from repro.configs import get_config as jget
from repro.models import decode as jdecode
from repro.parallel import compress as jcompress
from repro.parallel import sharding as jshd
from repro.runtime import elastic as jelastic
from repro_torch import dist
from repro_torch.configs import get_config as tget
from repro_torch.launch import mesh as tmesh
from repro_torch.models import model as tmodel
from repro_torch.models import decode as tdecode
from repro_torch.parallel import compress as tcompress
from repro_torch.parallel import sharding as tshd
from repro_torch.runtime import elastic as telastic

from _torch_mesh import flat_names

MESHES = (((4, 2), ("data", "model")), ((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model")))


def _jmesh(shape, axes):
    """A real jax Mesh on the one CPU device repeated (the rules read only
    its shape and names), as tests/test_sharding_rules.py builds it."""
    n = int(np.prod(shape))
    devs = np.array(jax.devices() * n)[:n]
    return JMesh(devs.reshape(shape), axes)


def _spec(p):
    return tuple(p)


@functools.lru_cache(maxsize=None)
def _leaves(arch):
    """(path, shape) of every leaf of the architecture's params (on
    ``meta``), once an architecture."""
    return tuple((tuple(name.split("/")), tuple(leaf.shape)) for name, leaf
                 in flat_names(tmodel.param_specs(tget(arch))))


def test_divisibility_guard_drops_axes():
    tm, jm = dist.Mesh((4, 2), ("data", "model")), _jmesh((4, 2),
                                                          ("data", "model"))
    for v in (51865, 51200):
        path = ("embed", "table")
        got = tshd.infer_param_spec(path, (v, 512), tm)
        assert _spec(got) == _spec(jshd.infer_param_spec(path, (v, 512), jm))
    assert tshd.infer_param_spec(("embed", "table"), (51865, 512), tm)[0] \
        is None
    assert tshd.infer_param_spec(("embed", "table"), (51200, 512), tm)[0] \
        == "model"


@pytest.mark.parametrize("layout", ["tp", "fsdp"])
def test_expert_rule_keeps_ep_in_both_layouts(layout):
    tm, jm = dist.Mesh((4, 2), ("data", "model")), _jmesh((4, 2),
                                                          ("data", "model"))
    path = ("layers_stacked", "moe", "w_up")
    got = tshd.infer_param_spec(path, (8, 16, 2048, 1408), tm, layout=layout)
    assert got[1] == "model"
    assert _spec(got) == _spec(jshd.infer_param_spec(
        path, (8, 16, 2048, 1408), jm, layout=layout))


def test_fsdp_layout_row_shards_everything():
    tm, jm = dist.Mesh((4, 2), ("data", "model")), _jmesh((4, 2),
                                                          ("data", "model"))
    path = ("layers_stacked", "attn", "wq")
    for layout, want in (("fsdp", (None, ("data", "model"), None)),
                         ("tp", (None, "data", "model"))):
        got = tshd.infer_param_spec(path, (8, 4096, 4096), tm, layout=layout)
        assert _spec(got) == want == _spec(jshd.infer_param_spec(
            path, (8, 4096, 4096), jm, layout=layout))


def test_small_leaves_replicated():
    tm = dist.Mesh((4, 2), ("data", "model"))
    assert tshd.infer_param_spec(("final_norm", "scale"), (4096,), tm) == \
        tshd.P() == ()


def test_constrain_outside_mesh_is_noop():
    x = torch.ones((4, 4))
    assert tshd.constrain(x, ("batch", None)) is x


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: "x".join(map(str, m[0])))
@pytest.mark.parametrize("arch", JARCH_IDS)
def test_every_leaf_spec_equals_jax(arch, mesh):
    """Every leaf of the architecture's params (on ``meta``) under both
    layouts, as params and as optimizer state: the port's spec is JAX's."""
    tm = dist.Mesh(*mesh)
    leaves = _leaves(arch)
    for layout in ("tp", "fsdp"):
        for opt in (False, True):
            for path, shape in leaves:
                got = tshd.infer_param_spec(path, shape, tm, opt_state=opt,
                                            layout=layout)
                want = jshd.infer_param_spec(path, shape, tm, opt_state=opt,
                                             layout=layout)
                assert _spec(got) == _spec(want), (path, layout, opt)
    assert leaves


@pytest.mark.parametrize("layout", ["tp", "fsdp"])
@pytest.mark.parametrize("mesh", MESHES[:1] + MESHES[2:],
                         ids=lambda m: "x".join(map(str, m[0])))
def test_batch_sharding_equals_jax(mesh, layout):
    tm, jm = dist.Mesh(*mesh), _jmesh(*mesh)
    for ndim in (1, 2, 3):
        for dim in range(ndim):
            for bs in (None, 1, 2, 8, 12, 64, 512, 1024):
                got = tshd.batch_sharding(tm, ndim, dim, bs, layout=layout)
                want = jshd.batch_sharding(jm, ndim, dim, bs, layout=layout)
                assert _spec(got) == _spec(want.spec), (ndim, dim, bs)
    assert tshd.batch_axes(tm, layout) == jshd.batch_axes(jm, layout)


@pytest.mark.parametrize("arch", ["qwen2-7b", "recurrentgemma-2b",
                                  "moonshot-v1-16b-a3b", "starcoder2-15b"])
@pytest.mark.parametrize("decode_attention", ["split_kv", "local"])
def test_state_shardings_equal_jax(arch, decode_attention):
    mesh = ((2, 4), ("data", "model"))
    tm, jm = dist.Mesh(*mesh), _jmesh(*mesh)
    jcfg, tcfg = (get(arch) for get in (jget, tget))
    jcfg = jcfg.replace(parallel=jcfg.parallel.replace(
        decode_attention=decode_attention))
    tcfg = tcfg.replace(parallel=tcfg.parallel.replace(
        decode_attention=decode_attention))
    for batch, seq in ((8, 64), (3, 60)):
        tstate = tdecode.init_decode_state(tcfg, batch, seq, "meta")
        jstate = jax.eval_shape(
            lambda: jdecode.init_decode_state(jcfg, batch, seq))
        got = {"/".join(map(str, p)): s for p, s in tshd._named(
            tdecode.state_shardings(tcfg, tstate, tm, batch))}
        want = {jshd._path_str(p): s.spec for p, s in
                jax.tree_util.tree_leaves_with_path(
                    jdecode.state_shardings(jcfg, jstate, jm, batch))}
        assert got.keys() == want.keys()
        for k in got:
            assert _spec(got[k]) == _spec(want[k]), (k, batch, seq)


def test_best_mesh_shape_equals_jax():
    for n in range(1, 513):
        assert telastic.best_mesh_shape(n) == jelastic.best_mesh_shape(n), n
    for n, mp in ((8, 2), (16, 4), (12, 3)):
        assert telastic.best_mesh_shape(n, mp) == \
            jelastic.best_mesh_shape(n, mp)
    m = telastic.make_elastic_mesh(4)
    assert m.shape == {"data": 2, "model": 2} and m.size == 4


def test_production_mesh_shape():
    assert tmesh.make_production_mesh() == ((16, 16), ("data", "model"))
    assert tmesh.make_production_mesh(multi_pod=True) == \
        ((2, 16, 16), ("pod", "data", "model"))
    m = tmesh.make_mesh((2, 4), ("data", "model"))
    assert isinstance(m, dist.LocalMesh) and m.shape == {"data": 2,
                                                         "model": 4}


@pytest.mark.parametrize("seed", range(4))
def test_quantize_bit_equal_jax(seed):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(33, 17)) * 10 ** rng.uniform(-3, 3)).astype(
        np.float32)
    err = (rng.normal(size=x.shape) * 1e-3).astype(np.float32)
    if seed == 0:     # exact halves of the scale: round half to even
        x = np.resize(np.arange(-127, 127.5, 0.5, dtype=np.float32),
                      x.shape).astype(np.float32)
        err = np.zeros_like(x)
    jq, js, je = jcompress.quantize(jnp.asarray(x), jnp.asarray(err))
    tq, ts, te = tcompress.quantize(torch.from_numpy(x),
                                    torch.from_numpy(err))
    assert tq.dtype == torch.int8
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    assert np.float32(ts) == np.float32(js)
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    np.testing.assert_array_equal(
        tcompress.dequantize(tq, ts).numpy(),
        np.asarray(jcompress.dequantize(jq, js)))
