"""The port's dry run (``launch/dryrun.py`` over ``dist.ShapeMesh`` and
``launch/roofline.py::StepCounter``) against real runs and against the JAX
package's dry run.

- ``ShapeMesh`` against ``LocalMesh`` on (2, 2, 2), every collective over
  every axis and tuple of axes: each rank's result shape, ``Mesh.bytes``
  (by rank: ``RankBytesMesh``) and the gradient's shape equal the real
  run's on real tensors.
- The smoke configs of qwen2-7b, arctic-480b (``move_compute`` and
  ``move_data``), recurrentgemma-2b, xlstm-125m, whisper-base and
  llava-next-34b on (2, 1, 2) (and on (2, 4) in
  ``tests/test_torch_dryrun_mesh.py``): a prefill, a decode step and a
  training step traced on a ``ShapeMesh`` give every rank's bytes and dot
  flops on a real ``LocalMesh`` run
  (``tests/_torch_dryrun.py::check_steps``). Exact integers.
- The ``meta`` trace of each smoke arch (the xLSTM's scans and the
  attention's tiles traced once, counted by ``repeated``) gives a CPU
  run's dot flops, forward, backward, prefill and decode, exactly.
- Against JAX (``jax.eval_shape`` in one subprocess, never ``lower_cell``:
  ``repro.launch.dryrun`` sets a 512-device flag at import): for the ten
  archs x their shapes x both meshes ``analytic_flops``,
  ``param_bytes_per_dev``, ``mem_bytes_per_dev`` and the skip list equal;
  a one-device prefill's dot flops of the qwen2-7b and arctic-480b smoke
  configs equal ``analyze_hlo``'s on JAX's compiled prefill.
"""
import math

import pytest
import torch

from repro_torch import dist
from repro_torch.configs import ARCH_IDS, SHAPES, get_config
from repro_torch.configs import get_smoke_config
from repro_torch.launch import dryrun as dr
from repro_torch.launch import roofline as rl
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.steps import make_prefill_step, opt_config_for
from repro_torch.models import build_model, decode_state_specs
from repro_torch.models import param_specs
from repro_torch.optim.optimizer import init_opt_state

from _torch_dryrun import (AXES3, CELLS, RankBytesMesh, check_steps,
                           finish_jax, start_jax, stop_jax)
from _torch_dryrun import one_thread  # noqa: F401 (fixture)

AXIS_SETS = [("pod",), ("data",), ("model",), ("pod", "data"),
             ("pod", "model"), ("data", "model"), ("model", "pod"),
             ("pod", "data", "model"), ("model", "data", "pod")]


def _op(comm, kind, axes, x):
    n = comm.axis_size(axes)
    if kind == "all_gather":
        return comm.all_gather(x, axes, 1)
    if kind == "psum_scatter":
        return comm.psum_scatter(x, axes, 1)
    if kind == "all_to_all":
        return comm.all_to_all(x, axes, 1, 0)
    if kind == "ppermute":
        return comm.ppermute(x, axes, [(i, (i + 1) % n) for i in range(n)])
    return getattr(comm, kind)(x, axes)


@pytest.mark.parametrize("kind", ["all_gather", "psum_scatter",
                                  "all_to_all", "psum", "pmean", "pmax",
                                  "ppermute"])
def test_shape_mesh_collectives_equal_local_mesh(kind):
    grad = kind != "pmax"
    for axes in AXIS_SETS:
        real = RankBytesMesh((2, 2, 2), AXES3)
        xs = [torch.randn(4, 8, 3, requires_grad=grad) for _ in range(8)]
        outs = real.run(lambda c: _op(c, kind, axes, xs[c.rank]))
        if grad:
            dist.backward_ranks([o.sum() for o in outs], 1.0)
        for r in range(8):
            sm = dist.ShapeMesh((2, 2, 2), AXES3, rank=r)
            x = torch.empty(4, 8, 3, device="meta", requires_grad=grad)
            y = _op(sm.comm(r), kind, axes, x)
            assert y.shape == outs[r].shape and y.device.type == "meta"
            if grad:
                y.sum().backward()
                assert x.grad.shape == xs[r].grad.shape
            assert sm.bytes == real.of(r), (kind, axes, r)
            fwd = [c for c in sm.records if not c.backward]
            assert len(fwd) == 1 and fwd[0].n == real.axis_size(axes)
            assert (len(sm.records) == 2) == grad


@pytest.mark.parametrize("arch,par", CELLS,
                         ids=[f"{a}-{p.get('moe_strategy', '')}"
                              for a, p in CELLS])
def test_shape_mesh_steps_equal_local_mesh(arch, par):
    check_steps(arch, par, (2, 1, 2), AXES3)


META_ARCHS = ["qwen2-7b", "arctic-480b", "recurrentgemma-2b", "xlstm-125m",
              "whisper-base", "llava-next-34b"]


def _counts(cfg, dev):
    """Dot flops of a loss with its backward (the config's remat, full),
    of a prefill and of a decode step, one device, on ``dev``."""
    api = build_model(cfg)
    p = api.init(0, device=dev)
    s = 48 + cfg.num_patches
    g = torch.Generator().manual_seed(0)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, s), generator=g,
                                     dtype=torch.int32)}
    if cfg.family == "vlm":
        batch = {"tokens": batch["tokens"][:, cfg.num_patches:],
                 "patch_embeds": torch.randn(2, cfg.num_patches, cfg.d_model,
                                             generator=g).to(torch.bfloat16)}
    if cfg.family == "audio":
        batch["frames"] = torch.randn(2, cfg.encoder_seq, cfg.d_model,
                                      generator=g).to(torch.bfloat16)
    batch = {k: v.to(dev) for k, v in batch.items()}
    out = []
    c = rl.StepCounter()
    with c:
        for x in torch.utils._pytree.tree_leaves(p):
            x.requires_grad_(True)
        loss, _ = api.loss(p, batch)
        out.append(c.dot_flops)
        loss.backward()
    out.append(c.dot_flops)
    with torch.no_grad():
        for step in ("prefill", "decode"):
            c = rl.StepCounter()
            with c:
                if step == "prefill":
                    _, st = api.prefill(p, batch, pad_cache_to=s + 4)
                else:
                    api.decode_step(p, st, batch["tokens"][:, -1])
            out.append(c.dot_flops)
    return out


@pytest.mark.parametrize("arch", META_ARCHS)
def test_meta_trace_counts_equal_a_cpu_run(arch):
    """The dry run's ``meta`` trace (the attention's tiles and the xLSTM's
    scans traced once and counted by ``repeated``, forward and backward,
    under full remat) counts every dot flop a CPU run computes: the loss,
    its backward, a prefill and a decode step, exactly."""
    cfg = get_smoke_config(arch)
    assert cfg.parallel.remat == "full"
    assert _counts(cfg, "meta") == _counts(cfg, "cpu")


# ---------------------------------------------------------------- vs JAX
JAX_CODE = """
import json, math, jax, jax.numpy as jnp
from repro.configs import SHAPES, get_config, get_smoke_config, get_shape
from repro.configs.base import supports_long_context
from repro.launch import roofline as rl
from repro.launch.steps import opt_config_for
from repro.models import build_model, decode_state_specs, input_specs
from repro.optim.optimizer import init_opt_state
ARCHS = %r
def tb(t):
    return sum(math.prod(l.shape) * jnp.dtype(l.dtype).itemsize
               for l in jax.tree.leaves(t))
out = {}
for arch in ARCHS:
    cfg = get_config(arch)
    p = jax.eval_shape(build_model(cfg).init, jax.random.key(0))
    o = jax.eval_shape(lambda q: init_opt_state(q, opt_config_for(cfg)), p)
    for name, shape in SHAPES.items():
        st = tb(decode_state_specs(cfg, shape)) if shape.kind == "decode" \\
            else 0
        n_act = cfg.active_param_count()
        for ndev in (256, 512):
            key = f"{arch}|{name}|{ndev}"
            if name == "long_500k" and not supports_long_context(cfg):
                out[key] = {"skipped": True}
                continue
            pbytes = tb(p) / ndev
            tok = shape.global_batch * shape.seq_len / ndev
            act = tok * cfg.d_model * 2 * cfg.num_layers
            if shape.kind == "train":
                mem = 4 * pbytes + 2 * tb(o) / ndev + 12 * act
                mf = 6.0 * n_act * shape.global_batch * shape.seq_len
            elif shape.kind == "prefill":
                mem = pbytes + 6 * act
                mf = 2.0 * n_act * shape.global_batch * shape.seq_len
            else:
                mem = pbytes + 2 * st / ndev
                mf = 2.0 * n_act * shape.global_batch
            out[key] = {"skipped": False, "flops": mf, "pbytes": pbytes,
                        "mem": mem}
# a one-device prefill's dot flops from the compiled HLO
for arch in ("qwen2-7b", "arctic-480b"):
    cfg = get_smoke_config(arch)
    api = build_model(cfg)
    params = jax.eval_shape(api.init, jax.random.key(0))
    batch = {"tokens": jax.ShapeDtypeStruct((2, 32), jnp.int32)}
    hlo = jax.jit(lambda q, b: api.prefill(q, b)).lower(
        params, batch).compile().as_text()
    out["prefill_dot_flops|" + arch] = rl.analyze_hlo(hlo, 1)["dot_flops"]
import numpy as np
np.savez(OUT, json=np.array(json.dumps(out)))
"""


@pytest.fixture(scope="module", autouse=True)
def jax_proc(tmp_path_factory):
    """JAX's side in a subprocess of 1 host device, started before this
    file's first test so that it overlaps the port's runs."""
    path = str(tmp_path_factory.mktemp("dryrun") / "jax.npz")
    proc = start_jax(JAX_CODE % (list(ARCH_IDS),), path, 1)
    yield proc, path
    stop_jax(proc)


@pytest.fixture(scope="module")
def jax_ref(jax_proc):
    return finish_jax(*jax_proc)


def test_analytic_terms_and_skips_equal_jax(jax_ref):
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        params = param_specs(cfg)
        opt = init_opt_state(params, opt_config_for(cfg))
        for name, shape in SHAPES.items():
            state = decode_state_specs(cfg, shape) if \
                shape.kind == "decode" else None
            for multi_pod in (False, True):
                ndev = math.prod(make_production_mesh(
                    multi_pod=multi_pod)[0])
                want = jax_ref[f"{arch}|{name}|{ndev}"]
                reason = dr.skip_reason(cfg, shape)
                assert (reason is not None) == want["skipped"], (arch, name)
                if reason:
                    continue
                mem, pbytes = dr.analytic_memory(cfg, shape, ndev, params,
                                                 opt, state)
                assert dr.analytic_flops(cfg, shape) == want["flops"]
                assert pbytes == want["pbytes"], (arch, name)
                assert mem == want["mem"], (arch, name, ndev)


@pytest.mark.parametrize("arch", ["qwen2-7b", "arctic-480b"])
def test_prefill_dot_flops_equal_jax_hlo(jax_ref, arch):
    cfg = get_smoke_config(arch)
    api = build_model(cfg)
    c = rl.StepCounter()
    with c:
        make_prefill_step(api, None)(param_specs(cfg), {
            "tokens": torch.empty((2, 32), dtype=torch.int32,
                                  device="meta")})
    want = jax_ref["prefill_dot_flops|" + arch]
    assert abs(c.dot_flops - want) <= 0.01 * want, (c.dot_flops, want)


def test_lower_cell_record_keys_and_skip():
    rec = dr.lower_cell("qwen2-7b", "long_500k", False)
    assert rec["ok"] and rec["skipped"] and "full-attention" in rec["reason"]
