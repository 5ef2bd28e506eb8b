"""The dry run's ``ShapeMesh`` traces against real ``LocalMesh`` runs on
a (data 2, model 4) mesh: the smoke configs of qwen2-7b, arctic-480b
(``move_compute`` and ``move_data``), recurrentgemma-2b, xlstm-125m,
whisper-base and llava-next-34b, a prefill, a decode step and a training
step, every rank's bytes by (scope, kind) and dot flops exactly
(``tests/_torch_dryrun.py::check_steps``; (pod 2, data 1, model 2) in
``tests/test_torch_dryrun.py``)."""
import pytest

from _torch_dryrun import CELLS, check_steps, one_thread  # noqa: F401 (fixture)


@pytest.mark.parametrize("arch,par", CELLS,
                         ids=[f"{a}-{p.get('moe_strategy', '')}"
                              for a, p in CELLS])
def test_shape_mesh_steps_equal_local_mesh(arch, par):
    check_steps(arch, par, (2, 4), ("data", "model"))
