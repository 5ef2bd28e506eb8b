"""The port's serving driver (``repro_torch.launch.serve``) on the CPU
against the JAX package's (``repro.launch.serve``): the same tenant lines
(status, chunks, retries) and exit code, with and without a poisoned
slot."""
import argparse

import pytest

from repro.launch import serve as jserve
from repro.service import types as jtypes
from repro_torch.launch import serve
from repro_torch.service import types as ttypes


def _tenant_lines(out: str):
    return [line.split() for line in out.splitlines()
            if line.strip().startswith("tenant")]


@pytest.mark.parametrize("extra", [[], ["--poison-slot", "0"]])
def test_serve_smoke_matches_jax(capsys, extra):
    jtypes.RequestHandle._next_id = 0
    assert jserve.main(["--smoke", *extra]) == 0
    want = capsys.readouterr().out
    ttypes.RequestHandle._next_id = 0
    assert serve.main(["--smoke", "--device", "cpu", *extra]) == 0
    got = capsys.readouterr().out
    assert _tenant_lines(got) == _tenant_lines(want)
    assert len(_tenant_lines(got)) == 3
    assert all("done" in line for line in _tenant_lines(got))
    assert got.splitlines()[-2:] == want.splitlines()[-2:]


def test_serve_lanes_run_fused():
    """The driver's lanes run the fused lowerings, which launch the
    hand-written kernels on the card (the JAX driver's run the reference
    ones: its service refuses the fused)."""
    cfg = serve.build_config(argparse.Namespace(neurons=32, levels=3,
                                                exchange="dense"))
    assert (cfg.activity_impl, cfg.connectivity_impl, cfg.tree_impl,
            cfg.apply_impl) == ("fused",) * 4
