"""Shared helpers of the dry-run step tests (``tests/test_torch_dryrun.py``
on (2, 1, 2), ``tests/test_torch_dryrun_mesh.py`` on (2, 4)): a smoke
config's prefill, decode step and training step (``remat="none"``; the
config's remat and ZeRO across pods in ``check_zero_train``) traced on a
``dist.ShapeMesh`` against every rank of a real ``LocalMesh`` run:
``Mesh.bytes`` by (scope, kind) a rank
(``RankBytesMesh``), dot flops a rank for the prefill and the decode step
(the counter entered inside each rank's function; dispatch modes are per
thread) and summed over the ranks for the training step (its backward runs
every rank's in the calling thread). Exact integers.

A trace is a function of its rank's block shapes (the params' blocks; the
batch splits evenly): one rank of each distinct set of block shapes is
traced, and its counts are held against every real rank of that set. The
traces run on CPU tensors, where the ShapeMesh's collectives return zeros
of their shapes: the same ops as on ``meta`` but the two ``meta``-only
loops (the attention's tiles and the xLSTM's scans, counted by
``dist.repeated``), at a third of the time; ``test_torch_dryrun.py`` holds
the ``meta`` traces' counts against CPU runs, and the dry-run matrix runs
on ``meta``."""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch import dist
from repro_torch.configs import get_smoke_config
from repro_torch.launch import roofline as rl
from repro_torch.launch.steps import (make_decode_step, make_prefill_step,
                                      make_train_step, opt_config_for)
from repro_torch.models import build_model
from repro_torch.optim.optimizer import (init_opt_state, leaves,
                                         shard_opt_state)
from repro_torch.parallel import sharding as shd

from _torch_mesh import SRC, TESTS

AXES3 = ("pod", "data", "model")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread while a file of these runs: the tensors are tiny,
    and a mesh's rank threads hand a baton on, which a machine busy with
    other workers' threads slows many times over. Restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def start_jax(code: str, out_path: str, devices: int):
    """Start ``code`` (which saves a ``json`` string with ``np.savez(OUT,
    json=...)``) in a subprocess of ``devices`` host devices, as
    ``_torch_mesh.run_jax`` runs it; a module fixture starts it before the
    file's first test so that it overlaps the port's runs."""
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([SRC, TESTS]),
               XLA_FLAGS=f"--xla_force_host_platform_device_count={devices} "
                         f"--xla_backend_optimization_level=0")
    head = f"OUT = {out_path!r}\n"
    return subprocess.Popen([sys.executable, "-c",
                             head + textwrap.dedent(code)], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def finish_jax(proc, out_path: str, timeout=300):
    """The ``start_jax`` subprocess's saved JSON."""
    out, err = proc.communicate(timeout=timeout)
    assert proc.returncode == 0, out[-3000:] + "\n" + err[-6000:]
    with np.load(out_path) as f:
        return json.loads(str(f["json"]))


def stop_jax(proc):
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


class RecordingComm(dist.LoneComm):
    """Runs every call of a real brain rank on ``inner`` and records it as
    ``dist.LoneComm`` does: the real rank's counts, made by the same
    code."""

    def __init__(self, inner):
        super().__init__(inner.num_ranks, inner.rank)
        self.inner = inner

    def all_gather(self, x):
        return self._record("all_gather", x, self.inner.all_gather(x))

    def all_to_all(self, buf):
        return self._record("all_to_all", buf, self.inner.all_to_all(buf))

    def psum(self, x):
        return self._record("psum", x, self.inner.psum(x))


def _counted_api(api, counters):
    """``api`` whose loss / prefill / decode step count their ops in a
    ``StepCounter`` of the calling rank (each rank's thread its own)."""
    def wrap(fn):
        def run(*a, **kw):
            rank = next(x.rank for x in list(a) + list(kw.values())
                        if isinstance(x, dist.MeshComm))
            c = counters.setdefault(rank, rl.StepCounter())
            with c:
                return fn(*a, **kw)
        return run
    return dataclasses.replace(api, loss=wrap(api.loss),
                               prefill=wrap(api.prefill),
                               decode_step=wrap(api.decode_step))


class RankBytesMesh(dist.LocalMesh):
    """A ``LocalMesh`` that also counts ``Mesh.bytes`` by rank: each
    collective's arriving bytes under (rank, scope, kind), as
    ``MeshComm._run`` counts them (it calls ``collective`` on a line of more
    than one rank only)."""

    def __init__(self, shape, axis_names):
        super().__init__(shape, axis_names)
        self.rank_bytes = {}

    def collective(self, rank, kind, axes, params, x):
        key = (rank, dist._scope_var.get(), kind)
        self.rank_bytes[key] = self.rank_bytes.get(key, 0) + \
            dist._arriving_bytes(kind, self.axis_size(axes),
                                 x.numel() * x.element_size())
        return super().collective(rank, kind, axes, params, x)

    def of(self, rank):
        """Rank ``rank``'s bytes by (scope, kind); checks that the ranks'
        sum is ``Mesh.bytes``."""
        total = {}
        for (_, *k), v in self.rank_bytes.items():
            total[tuple(k)] = total.get(tuple(k), 0) + v
        assert total == self.bytes
        return {k[1:]: v for k, v in self.rank_bytes.items() if k[0] == rank}


CELLS = [("qwen2-7b", {}), ("arctic-480b", {"moe_strategy": "move_compute"}),
         ("arctic-480b", {"moe_strategy": "move_data"}),
         ("recurrentgemma-2b", {}), ("xlstm-125m", {}), ("whisper-base", {}),
         ("llava-next-34b", {})]


def _config(arch, par):
    base = get_smoke_config(arch)
    return base.replace(capacity_factor=4.0, parallel=base.parallel.replace(
        remat="none", **par))


def _batch(cfg, b, s, seed=0):
    g = torch.Generator().manual_seed(seed)
    toks = torch.randint(0, cfg.vocab_size, (b, s), generator=g,
                         dtype=torch.int32)
    out = {"tokens": toks}
    if cfg.family == "vlm":
        out["tokens"] = toks[:, :s - cfg.num_patches]
        out["patch_embeds"] = torch.randn(b, cfg.num_patches, cfg.d_model,
                                          generator=g).to(torch.bfloat16)
    if cfg.family == "audio":
        out["frames"] = torch.randn(b, cfg.encoder_seq, cfg.d_model,
                                    generator=g).to(torch.bfloat16)
    return out


def _traced_step(api, cfg, params, shape, axes, rank, kind, b, s):
    """One rank's prefill + decode (or training step) on a ShapeMesh:
    (prefill bytes, decode bytes, prefill flops, decode flops)."""
    sm = dist.ShapeMesh(shape, axes, rank=rank)
    sp = shd.shard_params(params, sm)
    batch = _batch(cfg, b, s)
    c1, c2 = rl.StepCounter(), rl.StepCounter()
    if kind == "train":
        opt = init_opt_state(sp, opt_config_for(cfg))
        with c1:
            make_train_step(api, sm, opt_config_for(cfg))(sp, opt, batch)
        return dict(sm.bytes), {}, c1.dot_flops, 0
    with c1:
        _, st = make_prefill_step(api, sm)(sp, batch)
    pre = dict(sm.bytes)
    sm.bytes.clear()
    with c2:
        make_decode_step(api, sm)(sp, st, batch["tokens"][:, -1])
    return pre, dict(sm.bytes), c1.dot_flops, c2.dot_flops


def _rank_classes(sp, size):
    """The ranks grouped by their blocks' shapes: {first rank: ranks}."""
    out = {}
    for r in range(size):
        sig = tuple(tuple(x.shape) for x in leaves(shd.local_tree(sp, r)))
        out.setdefault(sig, []).append(r)
    return {rs[0]: rs for rs in out.values()}


def check_steps(arch, par, shape, axes):
    cfg = _config(arch, par)
    b, s = 4, 16 + cfg.num_patches
    mesh = RankBytesMesh(shape, axes)
    api = build_model(cfg)
    params = api.init(0, device="cpu")
    sp = shd.shard_params(params, mesh)
    classes = _rank_classes(sp, mesh.size)
    batch = _batch(cfg, b, s)
    # serving: a prefill and a decode step, counted a rank
    counters = {}
    capi = _counted_api(api, counters)
    _, states = make_prefill_step(capi, mesh)(sp, batch)
    pre = {r: mesh.of(r) for r in range(mesh.size)}
    pre_fl = {r: c.dot_flops for r, c in counters.items()}
    mesh.bytes.clear()
    mesh.rank_bytes.clear()
    counters.clear()
    make_decode_step(capi, mesh)(sp, states, batch["tokens"][:, -1])
    dec = {r: mesh.of(r) for r in range(mesh.size)}
    dec_fl = {r: c.dot_flops for r, c in counters.items()}
    for r0, ranks in classes.items():
        got = _traced_step(api, cfg, params, shape, axes, r0, "serve", b, s)
        for r in ranks:
            assert got[0] == pre[r] and got[1] == dec[r], (r0, r)
            assert got[2] == pre_fl[r] and got[3] == dec_fl[r], (r0, r)
    # training: the bytes a rank, the flops summed over the ranks
    mesh.bytes.clear()
    mesh.rank_bytes.clear()
    counters.clear()
    opt = init_opt_state(sp, opt_config_for(cfg))
    main = rl.StepCounter()
    with main:              # the backward of every rank, in this thread
        make_train_step(capi, mesh, opt_config_for(cfg))(sp, opt, batch)
    real_fl = main.dot_flops + sum(c.dot_flops for c in counters.values())
    traced_fl = 0
    for r0, ranks in classes.items():
        got = _traced_step(api, cfg, params, shape, axes, r0, "train", b, s)
        for r in ranks:
            assert got[0] == mesh.of(r), (r0, r)
        traced_fl += len(ranks) * got[2]
    assert traced_fl == real_fl


def check_zero_train(arch, par, shape, axes):
    """A training step with the config's remat (its recompute on every rank
    behind the baton) and m and v split by the optimizer-state rule (ZeRO
    across pods: the gradient reduce-scattered over ``pod``, the param
    all-gathered back): every rank's bytes by (scope, kind) traced on a
    ``ShapeMesh`` equal the ``LocalMesh`` run's. Returns the real run's
    kinds of collective."""
    base = get_smoke_config(arch)
    cfg = base.replace(capacity_factor=4.0,
                       parallel=base.parallel.replace(**par))
    b, s = 4, 16 + cfg.num_patches
    api = build_model(cfg)
    params = api.init(0, device="cpu")
    ocfg = opt_config_for(cfg)
    batch = _batch(cfg, b, s)
    mesh = RankBytesMesh(shape, axes)
    sp = shd.shard_params(params, mesh)
    make_train_step(api, mesh, ocfg)(
        sp, shard_opt_state(init_opt_state(params, ocfg), mesh), batch)
    for r0, ranks in _rank_classes(sp, mesh.size).items():
        sm = dist.ShapeMesh(shape, axes, rank=r0)
        make_train_step(api, sm, ocfg)(
            shd.shard_params(params, sm),
            shard_opt_state(init_opt_state(params, ocfg), sm), batch)
        for r in ranks:
            assert dict(sm.bytes) == mesh.of(r), (r0, r)
    return {k for _, k in mesh.bytes}
