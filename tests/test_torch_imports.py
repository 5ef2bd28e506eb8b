"""The port stands alone: no module of repro_torch, and not chip_smoke.py,
imports jax or the JAX package (an AST scan, and a fresh interpreter that
imports all of them and then inspects sys.modules). Entry points run on the
card unless told otherwise."""
import ast
import dataclasses
import os
import pathlib
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"
FILES = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_import(path):
    for name in _imported(path):
        top = name.split(".")[0]
        assert top not in FORBIDDEN, f"{path.name} imports {name}"


RUNTIME_FILES = sorted((PKG / "checkpoint").rglob("*.py")) + sorted(
    (PKG / "runtime").rglob("*.py"))


@pytest.mark.parametrize("path", RUNTIME_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_checkpoint_and_runtime_need_no_ml_dtypes(path):
    """The checkpoint manager reads bf16 leaves without ml_dtypes, which the
    card's machine does not have; nor does the runtime import it."""
    for name in _imported(path):
        top = name.split(".")[0]
        assert top not in FORBIDDEN + ("ml_dtypes",), \
            f"{path.name} imports {name}"


def test_fresh_interpreter_loads_no_jax():
    mods = sorted(
        "repro_torch." + str(p.relative_to(PKG).with_suffix("")).replace(
            os.sep, ".").replace(".__init__", "")
        for p in PKG.rglob("*.py"))
    code = ("import sys, importlib\n"
            f"sys.path.insert(0, {str(ROOT)!r})\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "import chip_smoke\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r})\n"
            "print(','.join(bad))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == ""


def test_simulator_defaults_to_the_card():
    from repro_torch.configs.msp_brain import SMOKE_CONFIG
    from repro_torch.sim.api import Simulator
    if torch.cuda.is_available():
        assert Simulator.from_config(SMOKE_CONFIG).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            Simulator.from_config(SMOKE_CONFIG)


def test_constructors_default_to_the_card():
    """``init_recorder`` and ``init_state`` without a device resolve it as
    the facade does: with no card they raise rather than build on the CPU
    (the card tests check that they land on ``cuda`` where there is one)."""
    if torch.cuda.is_available():
        pytest.skip("a card is visible: tests/test_torch_cuda.py covers it")
    from repro_torch.configs.msp_brain import SMOKE_CONFIG
    from repro_torch.core import engine
    from repro_torch.scenarios import observables
    with pytest.raises(RuntimeError, match="device='cpu'"):
        observables.init_recorder(4, 2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        engine.init_state(SMOKE_CONFIG, 0, 1)


def test_runner_and_elastic_default_to_the_card(tmp_path):
    """``SimulationRunner`` and ``elastic.remesh_restore_brain`` without a
    device resolve it as every entry point does: with no card they raise
    rather than run on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the runner then lands on cuda")
    from repro_torch.configs.msp_brain import SMOKE_CONFIG
    from repro_torch.runtime import elastic
    from repro_torch.runtime.sim_runner import (SimRunnerConfig,
                                                SimulationRunner)
    from repro_torch.sim.api import Simulator
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SimulationRunner(SimRunnerConfig(str(tmp_path)), cfg=SMOKE_CONFIG)
    Simulator.from_config(SMOKE_CONFIG, device="cpu").save(str(tmp_path))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        elastic.remesh_restore_brain(str(tmp_path), SMOKE_CONFIG)
    sim, step = elastic.remesh_restore_brain(str(tmp_path), SMOKE_CONFIG,
                                             device="cpu")
    assert step == 0 and sim.device.type == "cpu"


def test_converters_default_to_the_card():
    """``convert.state_from_numpy`` and ``neuron_params_from_numpy`` without
    a device resolve it as every entry point does: with no card they raise
    rather than build on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the converters then land on cuda")
    import types

    import numpy as np
    from repro_torch import convert
    from repro_torch.core.neuron import NeuronParams
    params = NeuronParams(*(np.full(4, x, np.float32)
                            for x in (0.02, 0.2, -65.0, 8.0, 1e-3, 0.7)))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        convert.neuron_params_from_numpy(params)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        convert.state_from_numpy(types.SimpleNamespace())
    assert convert.neuron_params_from_numpy(
        params, device="cpu").izh_a.device.type == "cpu"


def test_run_refuses_a_recorder_on_another_device():
    from repro_torch.configs.msp_brain import SMOKE_CONFIG
    from repro_torch.scenarios import observables
    from repro_torch.sim.api import Simulator
    sim = Simulator.from_config(SMOKE_CONFIG, device="cpu")
    rec = observables.init_recorder(2, 2, device="meta")
    with pytest.raises(ValueError, match="recorder lies on meta"):
        sim.run(1, recorder=rec)
    assert sim.state.chunk == 0


def test_config_validation_is_eager():
    from repro_torch.configs.msp_brain import SMOKE_CONFIG
    with pytest.raises(ValueError, match="activity_impl"):
        dataclasses.replace(SMOKE_CONFIG, activity_impl="pallas")
    with pytest.raises(ValueError, match="spike_alg"):
        dataclasses.replace(SMOKE_CONFIG, activity_impl="fused",
                            spike_alg="old")


def test_chip_smoke_refuses_without_a_card(monkeypatch, capsys):
    """On a machine with no card chip_smoke exits non-zero and prints no
    result line."""
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert chip_smoke.main() != 0
    assert '"ok": true' not in capsys.readouterr().out


def test_chip_smoke_refuses_alone_in_a_directory(tmp_path):
    """Copied alone into a directory (the port not beside it), chip_smoke
    exits non-zero and prints no result line, even where a card is seen."""
    lone = tmp_path / "chip_smoke.py"
    lone.write_text((ROOT / "chip_smoke.py").read_text())
    code = ("import runpy, sys, torch\n"
            "torch.cuda.is_available = lambda: True\n"
            f"runpy.run_path({str(lone)!r}, run_name='__main__')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=tmp_path, env=env)
    assert out.returncode != 0
    assert "not beside this script" in out.stderr
    assert '"ok": true' not in out.stdout


def test_service_and_serve_default_to_the_card():
    """``SlotBatch``, ``SimulationService`` and the serve driver without a
    device resolve it as every entry point does: with no card they raise
    rather than run on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the service then lands on cuda")
    from repro_torch.configs.msp_brain import SMOKE_CONFIG
    from repro_torch.launch import serve
    from repro_torch.service import SimulationService, SlotBatch
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SlotBatch(SMOKE_CONFIG, 2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SimulationService(SMOKE_CONFIG)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--smoke"])
    assert SlotBatch(SMOKE_CONFIG, 2, device="cpu").device.type == "cpu"


def test_lm_entry_points_default_to_the_card():
    """``build_model(cfg).init``, ``init_decode_state``, the LM serve
    driver and ``convert.lm_params_from_numpy`` without a device resolve it
    as every entry point does: with no card they raise rather than run on
    the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the LM then lands on cuda")
    import numpy as np
    from repro_torch import convert
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import serve_lm
    from repro_torch.models import build_model
    api = build_model(get_smoke_config("qwen2-7b"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        api.init(0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        api.init_decode_state(1, 8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve_lm.serve("qwen2-7b")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve_lm.main(["--arch", "qwen2-7b"])
    tree = {"embed": {"table": np.zeros((2, 3), np.float32)}}
    with pytest.raises(RuntimeError, match="device='cpu'"):
        convert.lm_params_from_numpy(tree)
    assert convert.lm_params_from_numpy(
        tree, device="cpu")["embed"]["table"].device.type == "cpu"
    assert api.init(0, device="meta")["embed"]["table"].device.type == "meta"
