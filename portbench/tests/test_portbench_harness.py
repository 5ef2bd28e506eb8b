"""The harness finds every configuration, mix, driver and reader by name
from files alone, and a run prints the contract's result line."""
from __future__ import annotations

import json
import re

import pytest

from conftest import small_run

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _spec():
    from portbench.bench import harness
    return harness.load_spec()


def test_every_name_resolves_to_its_own_file():
    from portbench.bench import harness
    spec = _spec()
    for c in spec["configs"]:
        path = harness.ROOT / c["file"]
        assert path.is_file(), c["file"]
        assert path == harness.BENCH / "configs" / f"{c['name']}.json"
        assert json.loads(path.read_text())["name"] == c["name"]
    for w in spec["workloads"]:
        tr = harness.load_json(harness.BENCH / "traffic" /
                               f"{w['traffic']}.json")
        drv = harness.driver_for(tr)
        assert callable(drv.run)
    for m in spec["per_layer"]:
        assert callable(harness.reader(m["name"]).read), m["name"]


def test_contract_shape():
    spec = _spec()
    assert list(spec) == ["command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"]
    assert 1 <= spec["run_seconds"] <= 51
    names = set()
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in spec[group]:
            assert NAME.match(e["name"]), e["name"]
            assert e["name"] not in names
            names.add(e["name"])
    e2e = {m["name"]: m for m in spec["end_to_end"]}
    assert "setup_s" in e2e
    for m in spec["end_to_end"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    cells = {w["name"] for w in spec["workloads"]}
    for m in spec["per_layer"]:
        assert UNIT.match(m["unit"]) and m["moves"] in e2e
        for w in m["workloads"]:
            assert w in cells
            moved = e2e[m["moves"]]
            assert "workloads" not in moved or w in moved["workloads"]
    for w in spec["workloads"]:
        assert w["chips"] == 1
        assert len(w["why"]) <= 200


def test_each_cell_reports_its_metrics():
    from portbench.bench import harness
    spec = _spec()
    for w in spec["workloads"]:
        e2e = {m["name"] for m in harness.end_to_end_of(spec, w)}
        assert "setup_s" in e2e and len(e2e) >= 2
        layer = harness.per_layer_of(spec, w)
        assert layer and all(m["moves"] in e2e for m in layer)


@pytest.mark.parametrize("cell", ["msp-512k.growth", "msp-512k.lesion",
                                  "qwen2-7b-train.s4096"])
@pytest.mark.parametrize("trace", [False, True])
def test_result_line(cell, trace):
    from portbench.bench import harness
    line = harness.run_cell(small_run(cell, trace=trace))
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "compared"
    assert line["correct"] is True
    assert line["attempted"] > 0 and line["failed"] == 0
    assert line["device"]["count"] == 1
    for v in line["compared"].values():
        assert v["value"] <= v["limit"]
    spec = harness.load_spec()
    w = harness.find_cell(spec, cell)
    if trace:
        assert "breakdown" in line
        assert {"busy_s", "window_s"} <= set(line["device"])
        want = {m["name"] for m in harness.per_layer_of(spec, w)}
        assert set(line["metrics"]) <= want
    else:
        assert set(line["metrics"]) == {
            m["name"] for m in harness.end_to_end_of(spec, w)}
        assert all(v["value"] > 0 for v in line["metrics"].values())


def test_main_refuses_without_a_card(capsys):
    """No CUDA device here: the command exits 2 and prints no result."""
    import torch
    from portbench.bench import harness
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    rc = harness.main(["--workload", "msp-512k.growth", "--seed", "1",
                       "--seconds", "1", "--trace", "0"])
    out = capsys.readouterr()
    assert rc == 2 and out.out == ""
    assert "CUDA" in out.err


def test_main_refuses_an_unknown_cell(capsys):
    from portbench.bench import harness
    rc = harness.main(["--workload", "nope", "--seed", "1", "--seconds", "1",
                       "--trace", "0"])
    assert rc == 2 and capsys.readouterr().out == ""
