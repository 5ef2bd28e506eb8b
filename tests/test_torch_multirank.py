"""The port's multi-rank simulation (R ranks, the paper's new algorithm,
dense rate exchange) against the JAX package at R=4, and its invariants.

The JAX reference runs in this process: ``jax.vmap(body, axis_name="ranks")``
over the stacked per-rank states runs ``repro.core.engine.init_state`` and
``repro.sim.phases`` with ``rank = jax.lax.axis_index("ranks")``, so the
tiled all-to-alls, the all-gathers and the psum run as on the mesh. That
reference is held once against the real mesh: a subprocess with four host
devices runs the JAX ``Simulator``, and its integer state equals the vmap
run's.

Tolerances: integer results (edge tables, counters, Morton/tree decisions)
and the rates table are bit-equal; ``init_state`` is bit-equal on every
rank. Over three free-running chunks the counters and edge tables are equal
up to the first chunk touched by a spike near-tie (none seen here; a
divergence is allowed only after the first chunk has matched, and printed),
and the activity floats v, u and calcium are within 2e-3 x max(|x|, 1) of
JAX's (ROADMAP Queue 3: they drift to 1.1e-3 free-running). Inside the port
fused == reference, ``LocalComm`` == ``ProcessGroupComm`` over gloo, and R=1
through a one-rank ``LocalComm`` are bitwise equal.
"""
import dataclasses
import os
import socket
import subprocess
import sys
import textwrap
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.msp_brain import BrainConfig as JConfig
from repro.core import engine as jengine
from repro.scenarios import Lesion, Recover, Stimulate
from repro.scenarios import library as jlib
from repro.sim import phases as jphases
from repro_torch import convert, dist
from repro_torch.configs.msp_brain import BrainConfig as TConfig
from repro_torch.core import engine as tengine
from repro_torch.sim import phases as tphases
from repro_torch.sim.api import Simulator as TSim

SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))
R = 4
CHUNKS = 3
SMALL = dict(neurons_per_rank=32, local_levels=3, frontier_cap=32,
             max_synapses=8, rate_period=25, requests_cap_factor=1000)
FUSED = dict(activity_impl="fused", connectivity_impl="fused",
             tree_impl="fused", apply_impl="fused")
COUNTERS = ("synapses_formed", "synapses_deleted", "bh_requests",
            "bh_responses", "formation_requests", "request_overflow",
            "rates_sent")
FLOAT_TOL = 2e-3


def _scaled_lesion(div=20):
    """lesion_rewiring with its event times divided by ``div`` (the lesion
    at step 50: the update closing chunk 1), as the JAX package's own
    multi-rank tests scale it."""
    scn = jlib.get_scenario("lesion_rewiring")
    evs = []
    for e in scn.events:
        if isinstance(e, Stimulate):
            evs.append(dataclasses.replace(
                e, t0=e.t0 // div, t1=max(e.t1 // div, e.t0 // div + 10)))
        elif isinstance(e, (Lesion, Recover)):
            evs.append(dataclasses.replace(e, t=e.t // div))
    return dataclasses.replace(scn, events=tuple(evs))


def _global(st):
    """A vmap-stacked JAX state (leading axis R on every leaf) -> the
    mesh's global view on the host: rows concatenated in rank order, the
    replicated rates table and chunk once."""
    st = jax.device_get(st)

    def cat(x):
        x = np.asarray(x)
        return x.reshape((-1,) + x.shape[2:])
    return st._replace(
        neurons=jax.tree.map(cat, st.neurons), out_edges=cat(st.out_edges),
        in_edges=cat(st.in_edges), positions=cat(st.positions),
        rates_table=np.asarray(st.rates_table)[0],
        chunk=np.asarray(st.chunk)[0], stats=jax.tree.map(cat, st.stats))


def _mesh_code(out_path):
    return textwrap.dedent(f"""
        import numpy as np
        from repro.configs.msp_brain import BrainConfig
        from repro.sim.api import Simulator
        sim = Simulator.from_config(BrainConfig(**{SMALL!r}))
        out = {{}}
        for c in range({CHUNKS}):
            st = sim.step()
            out[f"out_{{c}}"] = np.asarray(st.out_edges)
            out[f"in_{{c}}"] = np.asarray(st.in_edges)
            for k, v in st.stats.counters.items():
                out[f"{{k}}_{{c}}"] = np.asarray(v)
        assert sim.num_ranks == {R}, sim.num_ranks
        np.savez({out_path!r}, **out)
        print("MESH_OK")
    """)


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    """The JAX reference at R=4: the vmap run from the seed (the global
    state after init and after every chunk), the vmapped connectivity
    update with and without the scaled lesion scenario, and a subprocess
    running the JAX Simulator on a four-device mesh (waited for by the test
    that reads it)."""
    path = str(tmp_path_factory.mktemp("mesh") / "mesh.npz")
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"--xla_force_host_platform_device_count={R}")
    mesh = subprocess.Popen([sys.executable, "-c", _mesh_code(path)],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True, env=env)
    cfg = JConfig(**SMALL)

    def init_body(_):
        return jengine.init_state(cfg, jax.lax.axis_index("ranks"), R)

    def chunk_body(st):
        ctx = jphases.make_context(cfg, jax.lax.axis_index("ranks"), "ranks",
                                   R)
        return jphases.sim_chunk(st, ctx)

    st = jax.jit(jax.vmap(init_body, axis_name="ranks"))(jnp.arange(R))
    states = [_global(st)]
    chunk = jax.jit(jax.vmap(chunk_body, axis_name="ranks"))
    stacked = []
    for _ in range(CHUNKS):
        stacked.append(st)
        st = chunk(st)
        states.append(_global(st))

    def update(scn):
        def body(s):
            ctx = jphases.make_context(cfg, jax.lax.axis_index("ranks"),
                                       "ranks", R, scn)
            return jphases.connectivity_phase(s, ctx)
        # from the state after chunk 2 (chunk counter 2: the lesion at step
        # 50 has struck by the update's instant, 75)
        return _global(jax.jit(jax.vmap(body, axis_name="ranks"))(
            stacked[2]))

    updates = {None: update(None), "lesion": update(_scaled_lesion())}
    yield {"states": states, "updates": updates, "mesh": (mesh, path)}
    if mesh.poll() is None:
        mesh.kill()
        mesh.communicate()


# ------------------------------------------------------------ Comm semantics
def _ranks_input(r, num_ranks, cap=3):
    g = np.random.default_rng(100 + r)
    return (g.integers(-5, 1000, (num_ranks, cap, 2)).astype(np.int32),
            g.standard_normal((2, 3)).astype(np.float32),
            g.integers(0, 50, (6,)).astype(np.float32))


@pytest.mark.parametrize("num_ranks", [1, 2, 4])
def test_local_comm_collectives_match_numpy(num_ranks):
    """Tiled all-to-all (row d of rank s lands in row s of rank d), tiled
    all-gather and psum (rank order) against numpy, with ``SelfComm`` at
    one rank the identity."""
    group = dist.LocalComm(num_ranks)
    inputs = [_ranks_input(r, num_ranks) for r in range(num_ranks)]

    def body(r):
        c = group.comm(r)
        buf, x, v = (torch.from_numpy(a) for a in inputs[r])
        return (c.all_to_all(buf), c.all_gather(x), c.psum(v), c.rank,
                c.num_ranks)

    out = _run_with_timeout(lambda: group.run(
        [lambda r=r: body(r) for r in range(num_ranks)]))["value"]
    gathered = np.concatenate([i[1] for i in inputs])
    summed = np.stack([i[2] for i in inputs]).sum(0)
    for d, (a2a, ag, ps, rank, nr) in enumerate(out):
        assert (rank, nr) == (d, num_ranks)
        want = np.stack([inputs[s][0][d] for s in range(num_ranks)])
        np.testing.assert_array_equal(a2a.numpy(), want)
        np.testing.assert_array_equal(ag.numpy(), gathered)
        np.testing.assert_array_equal(ps.numpy(), summed)
    if num_ranks == 1:
        buf, x, v = (torch.from_numpy(a) for a in inputs[0])
        for op, t in (("all_to_all", buf), ("all_gather", x), ("psum", v)):
            assert getattr(dist.SINGLE, op)(t) is t


def _run_with_timeout(fn, seconds=30):
    box = {}

    def target():
        try:
            box["value"] = fn()
        except BaseException as e:      # noqa: B902 - handed to the test
            box["error"] = e
    t = threading.Thread(target=target, daemon=True)
    t.start()
    t.join(seconds)
    assert not t.is_alive(), "LocalComm.run hung"
    return box


@pytest.mark.parametrize("fault", ["raise", "mismatch", "early_exit"])
def test_local_comm_failing_rank_aborts_the_others(fault):
    """A rank that raises, reaches another collective than the others, or
    returns while they wait aborts every rank; the caller gets the error,
    and nothing hangs."""
    group = dist.LocalComm(4)

    def body(r):
        c = group.comm(r)
        x = torch.full((2,), float(r))
        c.psum(x)
        if r == 2:
            if fault == "raise":
                raise KeyError("rank 2 failed")
            if fault == "mismatch":
                return c.all_gather(x)
            return None
        c.psum(x)
        return c.all_gather(x)

    box = _run_with_timeout(
        lambda: group.run([lambda r=r: body(r) for r in range(4)]))
    want = KeyError if fault == "raise" else RuntimeError
    assert isinstance(box.get("error"), want), box
    # the group runs again afterwards
    out = group.run([lambda r=r: group.comm(r).psum(torch.ones(1))
                     for r in range(4)])
    assert [float(o) for o in out] == [4.0] * 4


def test_local_comm_baton_loses_no_update():
    """Sixteen ranks (more than the cores) with a tiny switch interval, each
    making a read-modify-write of one shared count between collectives (the
    kernels' launch counters do so): with one rank running at a time no
    update is lost, and the ranks run in rank order."""
    ranks, rounds = 16, 50
    group = dist.LocalComm(ranks)
    shared = {"count": 0, "order": []}

    def body(r):
        c = group.comm(r)
        for i in range(rounds):
            seen = shared["count"]
            sys.getswitchinterval()      # a chance to switch threads here
            shared["count"] = seen + 1
            shared["order"].append(r)
            if i % 5 == 4:
                c.psum(torch.ones(1))
        return r

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        box = _run_with_timeout(
            lambda: group.run([lambda r=r: body(r) for r in range(ranks)]),
            seconds=60)
    finally:
        sys.setswitchinterval(old)
    assert box.get("value") == list(range(ranks)), box
    assert shared["count"] == ranks * rounds
    # between two collectives the ranks run one after another, in order
    blocks = [shared["order"][i:i + 5] for i in range(0, ranks * rounds, 5)]
    assert [b[0] for b in blocks[:ranks]] == list(range(ranks))
    assert all(len(set(b)) == 1 for b in blocks)


# ------------------------------------------------------------ against JAX
def _assert_rank_states_equal_jax(states, want, what):
    got = convert.states_to_numpy(states)
    for f in ("out_edges", "in_edges", "positions", "rates_table"):
        np.testing.assert_array_equal(got[f], np.asarray(getattr(want, f)),
                                      err_msg=f"{what}: {f}")
    for f in ("v", "u", "calcium", "ax_elements", "de_elements", "spiked",
              "spike_count", "rate", "is_excitatory"):
        np.testing.assert_array_equal(
            got["neurons"][f], np.asarray(getattr(want.neurons, f)),
            err_msg=f"{what}: neurons.{f}")


def test_init_state_is_bit_equal_on_every_rank(jax_ref):
    """``init_state(cfg, rank, 4)`` for every rank: the ``fold_in(seed,
    rank)`` key and positions in the rank's block of Morton cells."""
    cfg = TConfig(**SMALL)
    states = [tengine.init_state(cfg, r, R, device="cpu") for r in range(R)]
    _assert_rank_states_equal_jax(states, jax_ref["states"][0], "init")
    from repro_torch.core import morton
    for r, st in enumerate(states):
        cells = morton.morton_encode(st.positions, morton.branch_level(R))
        c_per = morton.cells_per_rank(R)
        assert bool(((cells >= r * c_per) & (cells < (r + 1) * c_per)).all())


@pytest.mark.parametrize("impl", ["reference", "fused"])
@pytest.mark.parametrize("scenario", [None, "lesion"])
def test_one_update_from_an_injected_state(jax_ref, impl, scenario):
    """One connectivity update at R=4 from the JAX state after chunk 2,
    split into the ranks by ``convert.states_from_numpy``: edge tables,
    counters and the (R, n) rates table bit-equal to the vmapped JAX update;
    under the lesion the deletion messages cross ranks with live entries."""
    cfg = TConfig(**SMALL, **{f: impl for f in FUSED})
    scn = None if scenario is None else \
        convert.scenario_from_reference(_scaled_lesion())
    before = jax_ref["states"][2]
    states = convert.states_from_numpy(before, R, device="cpu")
    group = dist.LocalComm(R)
    ctxs = [tphases.make_context(cfg, r, R, scn, device="cpu",
                                 comm=group.comm(r)) for r in range(R)]
    out = group.run([lambda r=r: tphases.connectivity_phase(states[r],
                                                             ctxs[r])
                     for r in range(R)])
    want = jax_ref["updates"][scenario]
    got = convert.states_to_numpy(out)
    for f in ("out_edges", "in_edges", "rates_table"):
        np.testing.assert_array_equal(got[f], np.asarray(getattr(want, f)),
                                      err_msg=f)
    for k in COUNTERS:
        np.testing.assert_array_equal(
            got["stats"]["counters"][k], np.asarray(want.stats.counters[k]),
            err_msg=k)
    assert got["chunk"] == 3
    for t in out:    # every rank's copy of the replicated table
        np.testing.assert_array_equal(t.rates_table.numpy(),
                                      np.asarray(want.rates_table))
    deleted = got["stats"]["counters"]["synapses_deleted"].sum()
    if scenario == "lesion":
        n = cfg.neurons_per_rank
        old = np.asarray(before.out_edges).reshape(R, n, -1)
        src_rank = np.arange(R)[:, None, None]
        crossing = (old >= 0) & (old // n != src_rank)
        assert deleted > 0 and crossing.any()
    assert got["stats"]["counters"]["synapses_formed"].sum() > 0


def _run_port(impl_fields, chunks=CHUNKS, **kw):
    cfg = TConfig(**SMALL, **impl_fields)
    sim = TSim.from_config(cfg, num_ranks=R, device="cpu", **kw)
    states = [sim.init()]
    for _ in range(chunks):
        sim.step()
        states.append(sim.state)
    return sim, states


def test_three_chunks_from_the_seed_against_jax(jax_ref):
    """Three chunks at R=4 from the seed, both lowerings of the port against
    the JAX vmap run: per chunk the edge tables and every rank's counters
    equal (a divergence only after a first matching chunk, printed), the
    activity floats within FLOAT_TOL; fused == reference bitwise."""
    runs = {impl: _run_port({f: impl for f in FUSED})
            for impl in ("reference", "fused")}
    for a, b in zip(runs["reference"][1], runs["fused"][1]):
        assert torch.equal(a.out_edges, b.out_edges)
        assert torch.equal(a.in_edges, b.in_edges)
        for f in a.neurons._fields:
            assert torch.equal(getattr(a.neurons, f), getattr(b.neurons, f))
    states = runs["fused"][1]
    _assert_rank_states_equal_jax([states[0]], jax_ref["states"][0], "init")
    first_divergence = None
    for c in range(1, CHUNKS + 1):
        got = convert.state_to_numpy(states[c])
        want = jax_ref["states"][c]
        diff = {k: (np.asarray(want.stats.counters[k]).tolist(),
                    got["stats"]["counters"][k].tolist())
                for k in want.stats.counters
                if not np.array_equal(np.asarray(want.stats.counters[k]),
                                      got["stats"]["counters"][k])}
        same_counts = np.array_equal(np.asarray(want.neurons.spike_count),
                                     got["neurons"]["spike_count"]) and \
            np.array_equal(np.asarray(want.neurons.rate),
                           got["neurons"]["rate"])
        if diff or not same_counts:
            first_divergence = c - 1
            print(f"first near-tie divergence in chunk {c - 1}: {diff}")
            break
        for f in ("out_edges", "in_edges", "rates_table"):
            np.testing.assert_array_equal(got[f],
                                          np.asarray(getattr(want, f)))
        for f in ("v", "u", "calcium"):
            w = np.asarray(getattr(want.neurons, f))
            err = np.abs(got["neurons"][f] - w) / np.maximum(np.abs(w), 1.0)
            assert err.max() <= FLOAT_TOL, (c, f, err.max())
    print(f"counters equal for "
          f"{CHUNKS if first_divergence is None else first_divergence} of "
          f"{CHUNKS} chunks")
    assert first_divergence is None or first_divergence >= 1
    sim = runs["fused"][0]
    assert sim.health()["health_flags"] == 0.0
    stats = sim.stats()
    assert stats["synapses_formed"] > 0
    assert stats["rates_sent"] == CHUNKS * R * SMALL["neurons_per_rank"] \
        * (R - 1)


def test_vmap_reference_equals_the_mesh(jax_ref):
    """The vmap reference against the JAX Simulator on four host devices:
    edge tables and every rank's counters equal after every chunk."""
    mesh, path = jax_ref["mesh"]
    out, _ = mesh.communicate(timeout=300)
    assert mesh.returncode == 0 and "MESH_OK" in out, out
    got = np.load(path)
    for c in range(CHUNKS):
        want = jax_ref["states"][c + 1]
        np.testing.assert_array_equal(got[f"out_{c}"], want.out_edges)
        np.testing.assert_array_equal(got[f"in_{c}"], want.in_edges)
        for k, v in want.stats.counters.items():
            np.testing.assert_array_equal(got[f"{k}_{c}"], np.asarray(v),
                                          err_msg=k)


# ------------------------------------------------------------ invariants
def test_edge_symmetry_across_ranks():
    """Every out-edge (src, tgt) has its in-edge at the target, over all
    ranks, through the lesion (deletions cross ranks)."""
    scn = convert.scenario_from_reference(_scaled_lesion())
    cfg = TConfig(**SMALL, **FUSED)
    sim = TSim.from_config(cfg, scenario=scn, num_ranks=R, device="cpu")
    sim.run(3)
    st = sim.state
    n_all = st.out_edges.shape[0]
    rows = torch.arange(n_all)[:, None].expand_as(st.out_edges)
    out_pairs = torch.stack([rows[st.out_edges >= 0],
                             st.out_edges[st.out_edges >= 0]], 1)
    in_pairs = torch.stack([st.in_edges[st.in_edges >= 0],
                            rows[st.in_edges >= 0]], 1)
    key = lambda p: torch.sort(p[:, 0].long() * n_all + p[:, 1].long())[0]
    assert torch.equal(key(out_pairs), key(in_pairs))
    n = cfg.neurons_per_rank
    assert bool((out_pairs[:, 0] // n != out_pairs[:, 1] // n).any())
    s = sim.stats()
    assert s["synapses_deleted"] > 0 and sim.health()["health_flags"] == 0


def test_recorder_on_the_global_arrays_matches_jax():
    """At R=4 the recorder reads the global state (rows in rank order) after
    every chunk, as the JAX Simulator records its global arrays: the JAX
    ``observables.record`` on the same arrays gives equal counts and means
    within 1e-6 relative (f32 sum order) through the lesion."""
    from repro.scenarios import observables as jobs
    from repro.scenarios import protocol as jproto
    from repro_torch.scenarios import observables as tobs
    jscn = _scaled_lesion()
    cfg = TConfig(**SMALL, **FUSED)
    sim = TSim.from_config(cfg, scenario=convert.scenario_from_reference(jscn),
                           num_ranks=R, device="cpu")
    nb = len(jscn.regions) + 1
    rec = tobs.init_recorder(CHUNKS, nb, device="cpu")
    jrec = jobs.init_recorder(CHUNKS, nb)
    for _ in range(CHUNKS):
        st, rec = sim.run(1, recorder=rec)
        pos = jnp.asarray(st.positions.numpy())
        jrec = jobs.record(
            jrec, pos, jnp.asarray(st.neurons.calcium.numpy()),
            jnp.asarray(st.neurons.rate.numpy()),
            jnp.asarray(st.out_edges.numpy()), jscn.regions,
            jproto.alive_mask(jscn.events, jscn.regions, pos,
                              st.chunk * cfg.rate_period))
    got, want = tobs.flush(rec), jobs.flush(jrec)
    for k in ("synapses", "alive", "connectome", "rate_hist"):
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)
    for k in ("calcium", "rate"):
        np.testing.assert_allclose(got[k], np.asarray(want[k]), rtol=1e-6,
                                   atol=0, err_msg=k)
    assert got["alive"][-1, 0] == 0 and got["alive"][0, 0] > 0


def test_one_rank_through_local_comm_is_unchanged():
    """R=1 through a one-rank ``LocalComm`` (a thread and the baton) equals
    the plain one-rank simulator bitwise, counters included."""
    cfg = TConfig(**SMALL, **FUSED)
    sim = TSim.from_config(cfg, device="cpu")
    sim.run(2)
    group = dist.LocalComm(1)
    ctx = tphases.make_context(cfg, 0, 1, device="cpu", comm=group.comm(0))
    st = tengine.init_state(cfg, 0, 1, device="cpu")
    for _ in range(2):
        st = group.run([lambda st=st: tphases.sim_chunk(st, ctx)])[0]
    a = convert.state_to_numpy(sim.state)
    b = convert.state_to_numpy(st)
    for f in ("out_edges", "in_edges", "rates_table", "positions"):
        np.testing.assert_array_equal(a[f], b[f])
    for f in a["neurons"]:
        np.testing.assert_array_equal(a["neurons"][f], b["neurons"][f])
    for k in a["stats"]["counters"]:
        np.testing.assert_array_equal(a["stats"]["counters"][k],
                                      b["stats"]["counters"][k])


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


_GLOO_RANK = """
import numpy as np, torch, torch.distributed as tdist
from repro_torch import convert, dist
from repro_torch.configs.msp_brain import BrainConfig
from repro_torch.sim.api import Simulator
R, rank = {R}, {rank}
tdist.init_process_group("gloo", init_method="tcp://127.0.0.1:{port}",
                         world_size=R, rank=rank)
comm = dist.ProcessGroupComm()
# the three collectives against their definitions
g = np.random.default_rng(100 + rank)
buf = torch.from_numpy(g.integers(-5, 1000, (R, 3, 2)).astype(np.int32))
a2a = comm.all_to_all(buf)
ag = comm.all_gather(torch.full((2, 3), float(rank)))
ps = comm.psum(torch.arange(6, dtype=torch.float32) * (rank + 1))
assert a2a.shape == buf.shape and bool((a2a[rank] == buf[rank]).all())
assert ag.shape == (2 * R, 3) and [float(x) for x in ag[::2, 0]] == \\
    [float(r) for r in range(R)]
assert ps.tolist() == [float(i * R * (R + 1) // 2) for i in range(6)]
cfg = BrainConfig(**{small!r}, **{fused!r})
sim = Simulator.from_config(cfg, comm=comm, device="cpu")
sim.run({chunks})
stats, health = sim.stats(), sim.health()
st = convert.state_to_numpy(sim.state)
np.savez("{path}", out_edges=st["out_edges"], in_edges=st["in_edges"],
         v=st["neurons"]["v"], calcium=st["neurons"]["calcium"],
         rates_table=st["rates_table"],
         formed=np.float64(stats["synapses_formed"]),
         flags=np.float64(health["health_flags"]), a2a=a2a.numpy())
tdist.destroy_process_group()
print("RANK_OK")
"""


def test_local_comm_equals_process_group_over_gloo(tmp_path):
    """R=4 processes over gloo on the CPU (``ProcessGroupComm``, one rank a
    process) against ``LocalComm`` in this process: every rank's state
    bitwise equal after two chunks, ``stats()`` and ``health()`` equal."""
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=SRC)
    procs = []
    for r in range(R):
        code = _GLOO_RANK.format(R=R, rank=r, port=port, small=SMALL,
                                 fused=FUSED, chunks=2,
                                 path=str(tmp_path / f"rank{r}.npz"))
        procs.append(subprocess.Popen(
            [sys.executable, "-c", code], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True, env=env))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=240)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, out in zip(procs, outs):
        assert p.returncode == 0 and "RANK_OK" in out, out
    sim, _ = _run_port(FUSED, chunks=2)
    want_stats = sim.stats()
    for r, st in enumerate(sim.rank_states):
        got = np.load(tmp_path / f"rank{r}.npz")
        mine = convert.state_to_numpy(st)
        for f in ("out_edges", "in_edges", "rates_table"):
            np.testing.assert_array_equal(got[f], mine[f], err_msg=f)
        for f in ("v", "calcium"):
            np.testing.assert_array_equal(got[f], mine["neurons"][f])
        assert float(got["formed"]) == want_stats["synapses_formed"]
        assert float(got["flags"]) == sim.health()["health_flags"] == 0.0
