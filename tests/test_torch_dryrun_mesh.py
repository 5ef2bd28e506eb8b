"""The dry run's ``ShapeMesh`` traces against real ``LocalMesh`` runs on
a (data 2, model 4) mesh: the smoke configs of qwen2-7b, arctic-480b
(``move_compute`` and ``move_data``), recurrentgemma-2b, xlstm-125m,
whisper-base and llava-next-34b, a prefill, a decode step and a training
step, every rank's bytes by (scope, kind) and dot flops exactly
(``tests/_torch_dryrun.py::check_steps``; (pod 2, data 1, model 2) in
``tests/test_torch_dryrun.py``). On (pod 2, data 2, model 2) with every
leaf split, a training step with the config's remat and m and v split over
``pod`` (ZeRO across pods), as the dry run's train cells hold them: every
rank's bytes equal (``check_zero_train``), and ``trace_cell``'s
``opt_state_bytes`` is m and v of the rank's blocks by the
optimizer-state rule, half the params' blocks on the leaves it splits."""
import dataclasses
import math

import pytest

from repro_torch import dist
from repro_torch.configs import get_shape, get_smoke_config
from repro_torch.launch import dryrun as dr
from repro_torch.models import param_specs
from repro_torch.parallel import sharding as shd

from _torch_dryrun import (AXES3, CELLS, check_steps, check_zero_train,
                           one_thread)  # noqa: F401 (fixture)


@pytest.mark.parametrize("arch,par", CELLS,
                         ids=[f"{a}-{p.get('moe_strategy', '')}"
                              for a, p in CELLS])
def test_shape_mesh_steps_equal_local_mesh(arch, par):
    check_steps(arch, par, (2, 4), ("data", "model"))


@pytest.mark.parametrize("arch,par", CELLS[:2],
                         ids=[f"{a}-{p.get('moe_strategy', '')}"
                              for a, p in CELLS[:2]])
def test_shape_mesh_zero_remat_train_equals_local_mesh(arch, par,
                                                       monkeypatch):
    monkeypatch.setattr(shd, "_REPLICATE_BELOW", 0)
    kinds = check_zero_train(arch, par, (2, 2, 2), AXES3)
    # the update's reduce-scatter, its move to m's owner and the gather
    assert {"psum_scatter", "ppermute", "all_gather"} <= kinds


def test_dry_run_opt_state_bytes_zero_across_pods(monkeypatch):
    monkeypatch.setattr(shd, "_REPLICATE_BELOW", 0)
    cfg = get_smoke_config("qwen2-7b")
    shape = dataclasses.replace(get_shape("train_4k"), seq_len=32,
                                global_batch=8)
    mesh = dist.Mesh((2, 2, 2), AXES3)
    full = dict(shd._named(param_specs(cfg)))
    pspec = dict(shd._named(shd.param_specs(param_specs(cfg), mesh)))
    ospec = dict(shd._named(shd.param_specs(param_specs(cfg), mesh,
                                            opt_state=True)))

    def block(x, spec):
        return x.numel() // math.prod(mesh.axis_size(e) for e in spec if e)
    esize = dr.torch.empty((), dtype=getattr(
        dr.torch, cfg.parallel.opt_state_dtype)).element_size()
    today = sum(2 * esize * block(x, pspec[k]) for k, x in full.items())
    halved = sum(esize * block(x, pspec[k]) for k, x in full.items()
                 if ospec[k] != pspec[k])
    assert halved > 0
    _, _, mem, _ = dr.trace_cell(cfg, shape, (2, 2, 2), AXES3)
    assert mem["opt_state_bytes"] == today - halved + 4     # + the step
