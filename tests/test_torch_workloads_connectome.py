"""``Simulator.from_connectome`` in the port against the JAX package's, at
R=1 and R=4, under the dense and the sparse rate exchange, and the tree's
leaf sums on a layout whose rows are all clamped into one leaf.

The R=1 reference runs in this process (one host device). The R=4
reference is the JAX ``Simulator.from_connectome`` on four host devices in
one subprocess started once for the module: it saves the installed state
and the state after each of three chunks. The surrogate's rows are in global
Morton order, so most rows of ranks 1-3 lie outside their rank's block and
the tree build clamps them into the block's first or last leaf (the
reference's own semantics).

Tolerances: the installed state bit-equal in every field; after each chunk
the edge tables, every counter, the rates, the element counts and the
sparse registry (``subs``, ``rate_slots``, the pushed rates) bit-equal, and
v, u and calcium within ``LOADED_FLOAT_TOL`` = 1e-2 x max(|x|, 1). That is
five times ``_torch_ranks.FLOAT_TOL`` (2e-3, for runs that start from empty
tables): a loaded connectome drives every neuron through its synapses from
the first step, so the few-ulp difference of the Box-Muller noise (XLA:CPU
against torch; ROADMAP Queue 3) grows faster. Measured at R=4, dense, with
every integer equal: u within 1.5e-4, 1.3e-3 and 4.9e-3 after chunks 1-3,
v within 2.8e-4, calcium equal. The drift grows about fourfold a chunk, so
the tolerance holds for the three chunks compared here (``tr.CHUNKS``) and
no further. Inside the port, old == new connectivity
and sparse == dense are bitwise.
"""
import dataclasses
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import _torch_ranks as tr
from repro.configs.msp_brain import BrainConfig as JConfig
from repro.connectome import tree as jtree
from repro.sim.api import Simulator as JSim
from repro_torch import convert
from repro_torch.configs.msp_brain import BrainConfig as TConfig
from repro_torch.connectome import tree as ttree
from repro_torch.core import morton
from repro_torch.sim.api import Simulator as TSim
from repro_torch.telemetry import metrics as telemetry_metrics
from repro_torch.workloads import datasets as twds

N = tr.SMALL["neurons_per_rank"]
S = tr.SMALL["max_synapses"]
SPARSE = dict(subs_cap_factor=1000)   # head-room: the registry never overflows
SEED = 5
LOADED_FLOAT_TOL = 1e-2     # for tr.CHUNKS == 3 chunks: 4.9e-3 measured
NEURON_INTS = ("ax_elements", "de_elements", "is_excitatory", "rate",
               "spike_count")


def _dataset(ranks: int):
    return twds.generate_hemibrain_surrogate(
        ranks * N, N, avg_degree=4.0, max_degree=S, seed=SEED,
        fraction_excitatory=0.8)


def _fields(exchange: str) -> dict:
    return dict(tr.SMALL, rate_exchange=exchange,
                **(SPARSE if exchange == "sparse" else {}))


def _mesh_code(out_path: str) -> str:
    """The JAX reference at R=4 on four host devices: from_connectome under
    both exchanges, the installed state and three chunks, as an npz."""
    return textwrap.dedent(f"""
        import numpy as np
        from repro.configs.msp_brain import BrainConfig
        from repro.sim.api import Simulator
        from repro.workloads import datasets as wds
        ds = wds.generate_hemibrain_surrogate(
            4 * {N}, {N}, avg_degree=4.0, max_degree={S}, seed={SEED},
            fraction_excitatory=0.8)
        out = {{}}

        def save(st, key):
            for f in ("out_edges", "in_edges", "positions", "subs",
                      "rate_slots", "remote_rates"):
                x = getattr(st, f)
                if x is not None:
                    out[f"{{key}}/{{f}}"] = np.asarray(x)
            for f in st.neurons._fields:
                out[f"{{key}}/neurons/{{f}}"] = np.asarray(
                    getattr(st.neurons, f))
            for k, v in st.stats.counters.items():
                out[f"{{key}}/counters/{{k}}"] = np.asarray(v)

        for ex in ("dense", "sparse"):
            fields = {{"dense": {_fields("dense")!r},
                      "sparse": {_fields("sparse")!r}}}[ex]
            sim = Simulator.from_connectome(BrainConfig(**fields), ds)
            assert sim.num_ranks == 4, sim.num_ranks
            out[f"{{ex}}/subs_cap_base"] = np.int64(
                -1 if sim.cfg.subs_cap_base is None
                else sim.cfg.subs_cap_base)
            save(sim.state, f"{{ex}}/0")
            for c in range({tr.CHUNKS}):
                save(sim.step(), f"{{ex}}/{{c + 1}}")
            out[f"{{ex}}/health_flags"] = np.float64(
                sim.health()["health_flags"])
        np.savez({out_path!r}, **out)
        print("MESH_OK")
    """)


@pytest.fixture(scope="module")
def mesh_ref(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("mesh") / "from_connectome.npz")
    env = dict(os.environ, PYTHONPATH=tr.SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    proc = subprocess.Popen([sys.executable, "-c", _mesh_code(path)],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True, env=env)
    state = {}

    def get():
        if "npz" not in state:
            out, _ = proc.communicate(timeout=600)
            assert proc.returncode == 0 and "MESH_OK" in out, out
            state["npz"] = dict(np.load(path))
        return state["npz"]

    yield get
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


def _jax_r1(exchange: str):
    """The JAX reference at R=1 in this process: the installed state and
    three chunks, as flat dicts like the subprocess's."""
    cfg = JConfig(**_fields(exchange))
    sim = JSim.from_connectome(cfg, _dataset(1))
    states = [_flat_jax(sim.state)]
    for _ in range(tr.CHUNKS):
        states.append(_flat_jax(sim.step()))
    return sim.cfg.subs_cap_base, sim.health()["health_flags"], states


def _flat_jax(st) -> dict:
    out = {f: np.asarray(getattr(st, f)) for f in (
        "out_edges", "in_edges", "positions", "subs", "rate_slots",
        "remote_rates") if getattr(st, f) is not None}
    out.update({f"neurons/{f}": np.asarray(getattr(st.neurons, f))
                for f in st.neurons._fields})
    out.update({f"counters/{k}": np.asarray(v)
                for k, v in st.stats.counters.items()})
    return out


def _flat_port(st) -> dict:
    d = convert.state_to_numpy(st)
    out = {f: d[f] for f in ("out_edges", "in_edges", "positions", "subs",
                             "rate_slots", "remote_rates")
           if d[f] is not None}
    out.update({f"neurons/{f}": np.array(v)
                for f, v in d["neurons"].items()})
    out.update({f"counters/{k}": np.array(v)
                for k, v in d["stats"]["counters"].items()})
    return out


def _port_run(fields: dict, ranks: int, chunks: int = tr.CHUNKS,
              scenario=None):
    sim = TSim.from_connectome(TConfig(**fields), _dataset(ranks),
                               scenario=scenario, num_ranks=ranks,
                               device="cpu")
    states = [_flat_port(sim.state)]
    for _ in range(chunks):
        states.append(_flat_port(sim.step()))
    return sim, states


def _from_npz(npz: dict, prefix: str) -> dict:
    return {k[len(prefix) + 1:]: v for k, v in npz.items()
            if k.startswith(prefix + "/")}


def _assert_installed(got: dict, want: dict):
    """The installed state: every field bit-equal (the floats v, u and
    calcium are init_state's draws, bit-equal too)."""
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _assert_chunk(got: dict, want: dict, c: int):
    for k in want:
        if k.split("/")[-1] in ("v", "u", "calcium"):
            err = np.abs(got[k] - want[k]) / np.maximum(np.abs(want[k]), 1.0)
            assert err.max() <= LOADED_FLOAT_TOL, (c, k, err.max())
        elif k.startswith("counters/") or k in (
                "out_edges", "in_edges", "subs", "rate_slots",
                "remote_rates", "positions") or \
                k.split("/")[-1] in NEURON_INTS:
            np.testing.assert_array_equal(got[k], want[k],
                                          err_msg=f"chunk {c}: {k}")


@pytest.mark.parametrize("exchange", ["dense", "sparse"])
def test_from_connectome_at_one_rank_against_jax(exchange):
    """R=1: the installed state bit-equal to JAX's in every field, then
    three chunks (fused lowerings on the CPU: the plain versions) with the
    edge tables, counters, registry, rates and element counts equal, the
    activity floats within LOADED_FLOAT_TOL; ``subs_cap_base`` baked to 0; the
    health flags JAX's (the conservation bit: the loaded edges were never
    counted as formed)."""
    base, flags, want = _jax_r1(exchange)
    sim, got = _port_run(dict(_fields(exchange), **tr.FUSED), 1)
    _assert_installed(got[0], want[0])
    for c in range(1, tr.CHUNKS + 1):
        _assert_chunk(got[c], want[c], c)
    assert sim.cfg.subs_cap_base == base
    assert base == (0 if exchange == "sparse" else None)
    assert sim.health()["health_flags"] == flags == \
        telemetry_metrics.HEALTH_CONSERVATION


@pytest.mark.parametrize("exchange", ["dense", "sparse"])
def test_from_connectome_at_four_ranks_against_jax(mesh_ref, exchange):
    """R=4 (``dist.LocalComm``): the installed state bit-equal to the JAX
    Simulator's on four host devices, then three chunks as at R=1; the
    sparse registry sized from the measured remote sources."""
    npz = mesh_ref()
    sim, got = _port_run(dict(_fields(exchange), **tr.FUSED), 4)
    _assert_installed(got[0], _from_npz(npz, f"{exchange}/0"))
    for c in range(1, tr.CHUNKS + 1):
        _assert_chunk(got[c], _from_npz(npz, f"{exchange}/{c}"), c)
    want_base = int(npz[f"{exchange}/subs_cap_base"])
    if exchange == "sparse":
        assert sim.cfg.subs_cap_base == want_base == \
            twds.max_unique_remote_sources(_dataset(4), N) > 0
        assert sim.stats()["subscription_overflow"] == 0
    else:
        assert sim.cfg.subs_cap_base is None and want_base == -1
    assert sim.health()["health_flags"] == float(
        npz[f"{exchange}/health_flags"])


def test_loaded_connectome_clamps_rows_at_four_ranks():
    """The surrogate's layout at R=4: rows of ranks 1-3 outside their block
    (so clamped into a first or last leaf), and the installed tables are
    the dataset's own."""
    ds = _dataset(4)
    sim = TSim.from_connectome(TConfig(**tr.SMALL), ds, num_ranks=4,
                               device="cpu")
    out_e, in_e = twds.edge_tables(ds, S)
    np.testing.assert_array_equal(sim.state.out_edges.numpy(), out_e)
    np.testing.assert_array_equal(sim.state.in_edges.numpy(), in_e)
    cfg = sim.cfg
    clamped = []
    for r, st in enumerate(sim.rank_states):
        leaf_level, n_leaf, base = ttree._tree_geometry(r, cfg, 4)
        rel = morton.morton_encode(st.positions, leaf_level) \
            - base * 8 ** cfg.local_levels
        clamped.append(int(((rel < 0) | (rel >= n_leaf)).sum()))
    assert clamped[0] < N and sum(clamped[1:]) > 0, clamped


@pytest.mark.parametrize("ranks", [1, 4])
def test_old_equals_new_and_sparse_equals_dense_in_the_port(ranks):
    """Both sides the port's own code, from a loaded connectome through the
    lesion: old == new connectivity (edge tables sorted per row, as the JAX
    package's own test compares them) and sparse == dense (every field)
    bitwise, after every chunk."""
    scn = convert.scenario_from_reference(tr.scaled_lesion())
    fused = dict(tr.SMALL, **tr.FUSED)
    runs = {
        "dense": _port_run(dict(fused, rate_exchange="dense"), ranks, 4,
                           scn),
        "sparse": _port_run(dict(fused, rate_exchange="sparse", **SPARSE),
                            ranks, 4, scn),
        "old": _port_run(dict(fused, connectivity_alg="old",
                              requests_cap_factor=1000), ranks, 4, scn)}
    for a, b, o in zip(runs["dense"][1], runs["sparse"][1], runs["old"][1]):
        for k in ("out_edges", "in_edges"):
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
            np.testing.assert_array_equal(np.sort(a[k], 1), np.sort(o[k], 1),
                                          err_msg=k)
        for k in a:
            if k.startswith("neurons/"):
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
                np.testing.assert_array_equal(a[k], o[k], err_msg=k)
    dense, sparse = runs["dense"][0].stats(), runs["sparse"][0].stats()
    assert sparse["subscription_overflow"] == 0
    assert sparse["rates_sent"] <= dense["rates_sent"]
    assert dense["synapses_formed"] > 0


@pytest.mark.parametrize("impl", ["reference", "fused"])
@pytest.mark.parametrize("layout", ["one_leaf", "scattered"])
def test_leaf_sums_on_a_clamped_layout_against_jax(impl, layout):
    """Rank 2 of 4 at SMALL's widths: with every position outside the
    rank's block (all rows clamped into its first leaf), and with positions
    spread over the cube, the port's tree (plain ``_leaf_sums``, both
    lowerings) is bit-equal to JAX's ``build_local_tree`` in every level's
    counts and centroids and in the membership table."""
    import jax
    rng = np.random.default_rng(11)
    n = 200
    if layout == "one_leaf":
        # the first octant is rank 0's block at R=4
        pos = rng.uniform(0.0, 0.5, (n, 3)).astype(np.float32)
    else:
        pos = rng.uniform(0.0, 1.0, (n, 3)).astype(np.float32)
    w = rng.uniform(0.0, 3.0, n).astype(np.float32)
    w[rng.uniform(size=n) < 0.2] = 0.0
    cfg = dict(tr.SMALL, tree_impl=impl)
    want = jax.device_get(jtree.build_local_tree(pos, w, 2, JConfig(**cfg),
                                                 4))
    got = ttree.build_tree(TConfig(**cfg), torch.from_numpy(pos),
                           torch.from_numpy(w), 2, 4)
    for a, b in zip(got.counts + got.centroids, want.counts + want.centroids):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(got.leaf_members.numpy(),
                                  np.asarray(want.leaf_members))
    leaf_level, n_leaf, base = ttree._tree_geometry(2, TConfig(**cfg), 4)
    if layout == "one_leaf":
        assert (got.leaf_members[0] >= 0).all()
        assert float(got.counts[-1][0]) == float(
            np.asarray(want.counts[-1])[0]) > 0
        assert float(got.counts[-1][1:].abs().sum()) == 0.0
    # the plain leaf sums alone, as the kernel is held against them
    rel = torch.clamp(torch.from_numpy(np.asarray(jax.device_get(
        jtree.morton.morton_encode(pos, leaf_level))).astype(np.int32))
        - base * 8 ** tr.SMALL["local_levels"], 0, n_leaf - 1)
    slot = ttree.positions_within(rel, n_leaf)
    counts = ttree._leaf_sums(torch.from_numpy(w), rel, slot, n_leaf)
    np.testing.assert_array_equal(counts.numpy(), np.asarray(want.counts[-1]))


_GLOO_RANK = """
import numpy as np, torch.distributed as tdist
from repro_torch import convert, dist
from repro_torch.configs.msp_brain import BrainConfig
from repro_torch.sim.api import Simulator
from repro_torch.workloads import datasets as wds
tdist.init_process_group("gloo", init_method="tcp://127.0.0.1:{port}",
                         world_size=4, rank={rank})
ds = wds.generate_hemibrain_surrogate(4 * {n}, {n}, avg_degree=4.0,
                                      max_degree={s}, seed={seed},
                                      fraction_excitatory=0.8)
sim = Simulator.from_connectome(BrainConfig(**{fields!r}), ds,
                                comm=dist.ProcessGroupComm(), device="cpu")
out = {{}}
for c in range(3):
    st = convert.state_to_numpy(sim.state)
    for f in ("out_edges", "in_edges", "subs", "rate_slots", "remote_rates"):
        out[f"{{c}}/{{f}}"] = st[f]
    for f in ("ax_elements", "de_elements", "v"):
        out[f"{{c}}/{{f}}"] = st["neurons"][f]
    if c < 2:
        sim.step()
out["base"] = np.int64(sim.cfg.subs_cap_base)
np.savez("{path}", **out)
tdist.destroy_process_group()
print("RANK_OK")
"""


def test_from_connectome_under_a_process_group(tmp_path):
    """Four processes over gloo (``ProcessGroupComm``), sparse exchange:
    each process installs its own rank's block and rebuilds the registry
    through the group's collectives; the installed state and two chunks are
    bitwise those of the four ranks in one process (``LocalComm``)."""
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    fields = dict(_fields("sparse"), **tr.FUSED)
    env = dict(os.environ, PYTHONPATH=tr.SRC)
    procs = [subprocess.Popen(
        [sys.executable, "-c", _GLOO_RANK.format(
            port=port, rank=r, n=N, s=S, seed=SEED, fields=fields,
            path=str(tmp_path / f"rank{r}.npz"))],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
        for r in range(4)]
    try:
        outs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, out in zip(procs, outs):
        assert p.returncode == 0 and "RANK_OK" in out, out
    sim = TSim.from_connectome(TConfig(**fields), _dataset(4), num_ranks=4,
                               device="cpu")
    for c in range(3):
        for r, st in enumerate(sim.rank_states):
            got = np.load(tmp_path / f"rank{r}.npz")
            assert int(got["base"]) == sim.cfg.subs_cap_base
            mine = convert.state_to_numpy(st)
            for f in ("out_edges", "in_edges", "subs", "rate_slots",
                      "remote_rates"):
                np.testing.assert_array_equal(got[f"{c}/{f}"], mine[f],
                                              err_msg=f"{c}/{f}")
            for f in ("ax_elements", "de_elements", "v"):
                np.testing.assert_array_equal(got[f"{c}/{f}"],
                                              mine["neurons"][f],
                                              err_msg=f"{c}/{f}")
        if c < 2:
            sim.step()
