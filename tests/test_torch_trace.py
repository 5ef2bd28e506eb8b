"""The port's host spans (``repro_torch.telemetry.trace``): the JAX
package's span tests (``tests/test_telemetry.py``) run on the port, and
spans from two threads, each nesting in its own stack (``dist.LocalComm``
runs every rank in a thread of its own)."""
import threading

import pytest
import torch

from repro_torch import telemetry
from repro_torch.configs.msp_brain import BrainConfig
from repro_torch.sim.api import Simulator

SMALL = BrainConfig(neurons_per_rank=32, local_levels=3, frontier_cap=32,
                    max_synapses=8, rate_period=10, requests_cap_factor=100,
                    subs_cap_factor=100)


def test_span_nesting_depth_and_parent():
    telemetry.clear()
    with telemetry.span("outer", tag=1):
        with telemetry.span("inner"):
            pass
    inner, outer = telemetry.spans("inner")[-1], telemetry.spans("outer")[-1]
    assert inner.depth == 1 and inner.parent == "outer"
    assert outer.depth == 0 and outer.parent is None
    assert outer.attrs == {"tag": 1}
    assert outer.duration_ms >= inner.duration_ms >= 0.0
    # export() is JSON-shaped
    rec = [s for s in telemetry.export() if s["name"] == "inner"][-1]
    assert rec["parent"] == "outer" and rec["depth"] == 1


def test_simulator_records_spans():
    telemetry.clear()
    sim = Simulator(SMALL, device="cpu")
    sim.run(1)
    names = [s.name for s in telemetry.spans()]
    for expected in ("sim.construct", "sim.init", "sim.run"):
        assert expected in names, names
    run_span = telemetry.spans("sim.run")[-1]
    assert run_span.attrs.get("chunks") == 1
    # init runs before the run span opens, as in the JAX Simulator
    assert telemetry.spans("sim.init")[-1].parent is None


def test_profile_none_is_noop():
    with telemetry.profile(None):
        pass                                    # must not touch the profiler
    telemetry.clear()


def test_profile_writes_a_chrome_trace_with_the_span_ranges(tmp_path):
    """``profile(dir)`` writes a Chrome trace in which a span is the range
    ``repro.<name>``."""
    with telemetry.profile(str(tmp_path)):
        with telemetry.span("outer"):
            torch.ones(4).sum()
    text = (tmp_path / "trace.json").read_text()
    assert '"repro.outer"' in text


def test_each_thread_keeps_its_own_stack():
    """Spans opened in two threads at once nest only in their own thread's
    stack."""
    telemetry.clear()
    inside = threading.Barrier(2, timeout=30)

    def work(tag):
        with telemetry.span(f"outer.{tag}"):
            inside.wait()              # both outer spans open at once
            with telemetry.span(f"inner.{tag}"):
                inside.wait()

    threads = [threading.Thread(target=work, args=(t,)) for t in "ab"]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    for tag in "ab":
        inner = telemetry.spans(f"inner.{tag}")[-1]
        outer = telemetry.spans(f"outer.{tag}")[-1]
        assert (inner.depth, inner.parent) == (1, f"outer.{tag}")
        assert (outer.depth, outer.parent) == (0, None)


def test_the_ring_keeps_the_last_4096_spans():
    telemetry.clear()
    for i in range(4100):
        with telemetry.span("s", i=i):
            pass
    kept = telemetry.spans("s")
    assert len(kept) == 4096 and kept[0].attrs["i"] == 4
    telemetry.clear()
    assert telemetry.spans() == []


@pytest.mark.parametrize("num_ranks", [1, 4])
def test_rank_threads_do_not_nest_in_the_caller(num_ranks):
    """At R=4 the phases run in rank threads: the Simulator's own spans
    stay on the caller's thread, at depth 0 for ``sim.step``."""
    telemetry.clear()
    sim = Simulator(SMALL, num_ranks=num_ranks, device="cpu")
    sim.step()
    step = telemetry.spans("sim.step")[-1]
    assert (step.depth, step.parent) == (0, None)
