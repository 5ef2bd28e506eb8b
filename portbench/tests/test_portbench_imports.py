"""Nothing a run loads is JAX or the JAX package (top-level names compared
whole: ``repro_torch`` is the program, ``repro`` is not), and the
references load nothing of the program."""
from __future__ import annotations

import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[2]

RUN = r"""
import json, sys, time
sys.path[:0] = [{root!r}, {src!r}]
sys.path.insert(0, {tests!r})
from conftest import small_run
from portbench.bench import harness
for cell in ("msp-512k.lesion", "qwen2-7b-train.s4096"):
    harness.run_cell(small_run(cell, trace=True))
for m in harness.load_spec()["per_layer"]:
    harness.reader(m["name"])
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""

REF = r"""
import json, sys
sys.path[:0] = [{root!r}, {src!r}]
import portbench.reference.msp, portbench.reference.qwen2
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _tops(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", code.format(
            root=str(ROOT), src=str(ROOT / "src"),
            tests=str(ROOT / "portbench" / "tests"))],
        capture_output=True, text=True, timeout=600, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax():
    tops = _tops(RUN)
    assert "repro_torch" in tops and "portbench" in tops
    assert not tops & {"jax", "jaxlib", "flax", "repro"}


def test_the_references_load_nothing_of_the_program():
    tops = _tops(REF)
    assert not tops & {"repro_torch", "jax", "jaxlib", "flax", "repro"}


def test_the_check_compares_whole_names(monkeypatch):
    from portbench.bench import harness
    before = harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "repro_fake_x", sys)
    assert harness.forbidden_modules() == before
    monkeypatch.delitem(sys.modules, "repro", raising=False)
    monkeypatch.setitem(sys.modules, "repro.sub", sys)
    assert "repro" in harness.forbidden_modules()
