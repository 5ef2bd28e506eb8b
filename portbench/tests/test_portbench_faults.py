"""``correct`` comes out false when the timed path is broken underneath,
and for the control put in the program's place. Each test drives a whole
run of a cell at a small size on the CPU (the look for a card skipped),
first sound (``correct`` true), then with one fault of
``bench/faults.py`` planted in the program: a step that returns its state
unchanged; half of the batch left out; an answer altered where it is
produced. (The exchange between chips is no fault of these one-chip
cells.)"""
from __future__ import annotations

import pytest

from conftest import small_run

FAULTS = ("unchanged", "half", "answer")


def _correct(cell, **kw) -> bool:
    from portbench.bench import harness
    return harness.run_cell(small_run(cell, **kw))["correct"]


@pytest.mark.parametrize("cell", ["msp-512k.growth", "msp-512k.lesion",
                                  "qwen2-7b-train.s4096"])
@pytest.mark.parametrize("fault", FAULTS)
def test_fault_is_not_correct(cell, fault):
    from portbench.bench import faults
    kind = "train" if cell.startswith("qwen2") else "brain"
    assert _correct(cell)
    with faults.FAULTS[kind][fault]():
        assert not _correct(cell)
    assert _correct(cell)


@pytest.mark.parametrize("cell", ["msp-512k.growth", "msp-512k.lesion",
                                  "qwen2-7b-train.s4096"])
def test_control_is_not_correct(cell):
    """The reference in the next precision below the configuration's
    (bfloat16 state for the brain, float8 products for the LM) in the
    program's place."""
    from portbench.bench import harness
    r = small_run(cell, seed=5)
    r.control = True
    line = harness.run_cell(r)
    assert line["correct"]
    assert any(v > lim for v, lim in r.control_checks.values())
