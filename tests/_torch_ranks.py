"""Helpers of the tests that hold the port's paper comparisons (the old
connectivity algorithm, the old spike exchange, the sparse rate exchange)
against the JAX package at R ranks.

The JAX reference runs in the test process: ``jax.vmap(body,
axis_name="ranks")`` over the stacked per-rank states runs
``repro.core.engine.init_state`` and ``repro.sim.phases`` with ``rank =
jax.lax.axis_index("ranks")``, so the all-gathers, the tiled all-to-alls and
the psum run as on the mesh (at R=1 the phases skip them). ``mesh_code``
runs the JAX ``Simulator`` itself on four host devices in a subprocess, to
hold that reference once against the real mesh.

Tolerances (stated once, used by every file): integer results (edge tables,
counters, the subscription registry, the rates the exchanges carry) are
bit-equal while the spike flags agree; over free-running chunks a spike
near-tie may make the runs diverge, which is allowed only after a first
chunk has matched (printed); the activity floats v, u and calcium are within
``FLOAT_TOL`` x max(|x|, 1) of JAX's (ROADMAP Queue 3: they drift to 1.1e-3
free-running).
"""
import dataclasses
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs.msp_brain import BrainConfig as JConfig
from repro.core import engine as jengine
from repro.scenarios import library as jlib
from repro.sim import phases as jphases
from repro_torch import convert, dist
from repro_torch.configs.msp_brain import BrainConfig as TConfig
from repro_torch.sim import phases as tphases
from repro_torch.sim.api import Simulator as TSim

SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))
SMALL = dict(neurons_per_rank=32, local_levels=3, frontier_cap=32,
             max_synapses=8, rate_period=25, requests_cap_factor=1000)
FUSED = dict(activity_impl="fused", connectivity_impl="fused",
             tree_impl="fused", apply_impl="fused")
CHUNKS = 3
FLOAT_TOL = 2e-3
_RANK_ROWS = ("out_edges", "in_edges", "positions", "rate_slots")


def scaled_lesion(div: int = 20):
    """The JAX ``lesion_rewiring`` scenario with its lesion at step 1000 /
    ``div`` (the update closing chunk 1 at the default ``div``), as the JAX
    package's own multi-rank tests scale it."""
    scn = jlib.get_scenario("lesion_rewiring")
    return dataclasses.replace(scn, events=tuple(
        dataclasses.replace(e, t=e.t // div) for e in scn.events))


def global_view(st):
    """A vmap-stacked JAX state (leading axis R on every leaf) -> the
    mesh's global view on the host: per-rank rows concatenated in rank
    order, the replicated rates table and chunk once."""
    st = jax.device_get(st)

    def cat(x):
        if x is None:
            return None
        x = np.asarray(x)
        return x.reshape((-1,) + x.shape[2:])
    rows = {f: cat(getattr(st, f)) for f in _RANK_ROWS}
    return st._replace(
        neurons=jax.tree.map(cat, st.neurons),
        rates_table=None if st.rates_table is None
        else np.asarray(st.rates_table)[0],
        subs=cat(st.subs), remote_rates=cat(st.remote_rates),
        chunk=np.asarray(st.chunk)[0], stats=jax.tree.map(cat, st.stats),
        **rows)


def jax_run(fields: dict, num_ranks: int, chunks: int = CHUNKS,
            scenario=None):
    """The JAX reference from the seed: the global state after init and
    after every chunk, and the stacked per-rank states before every chunk
    (to inject into an update)."""
    cfg = JConfig(**fields)

    def init_body(_):
        return jengine.init_state(cfg, jax.lax.axis_index("ranks"),
                                  num_ranks, scenario)

    def chunk_body(st):
        ctx = jphases.make_context(cfg, jax.lax.axis_index("ranks"),
                                   "ranks", num_ranks, scenario)
        return jphases.sim_chunk(st, ctx)

    st = jax.jit(jax.vmap(init_body, axis_name="ranks"))(
        jnp.arange(num_ranks))
    states, stacked = [global_view(st)], []
    chunk = jax.jit(jax.vmap(chunk_body, axis_name="ranks"))
    for _ in range(chunks):
        stacked.append(st)
        st = chunk(st)
        states.append(global_view(st))
    return states, stacked


def jax_update(fields: dict, num_ranks: int, stacked, scenario=None):
    """One vmapped JAX connectivity update from stacked rank states."""
    cfg = JConfig(**fields)

    def body(s):
        ctx = jphases.make_context(cfg, jax.lax.axis_index("ranks"), "ranks",
                                   num_ranks, scenario)
        return jphases.connectivity_phase(s, ctx)
    return global_view(jax.jit(jax.vmap(body, axis_name="ranks"))(stacked))


def port_update(fields: dict, num_ranks: int, before, scenario=None):
    """One connectivity update of the port's ranks (``dist.LocalComm``) from
    a JAX global state split by ``convert.states_from_numpy``; the global
    result as numpy."""
    cfg = TConfig(**fields)
    scn = None if scenario is None else \
        convert.scenario_from_reference(scenario)
    states = convert.states_from_numpy(before, num_ranks, device="cpu")
    group = dist.LocalComm(num_ranks)
    ctxs = [tphases.make_context(cfg, r, num_ranks, scn, device="cpu",
                                 comm=group.comm(r))
            for r in range(num_ranks)]
    out = group.run([lambda r=r: tphases.connectivity_phase(states[r],
                                                             ctxs[r])
                     for r in range(num_ranks)])
    return convert.states_to_numpy(out)


def port_run(fields: dict, num_ranks: int, chunks: int = CHUNKS,
             scenario=None):
    """The port from the seed on the CPU: the simulator and the global
    state after init and after every chunk, as numpy (a copy: the metrics
    are updated in place)."""
    sim = TSim.from_config(TConfig(**fields), scenario=scenario,
                           num_ranks=num_ranks, device="cpu")
    def snapshot(st):
        return jax.tree.map(np.array, convert.state_to_numpy(st))
    states = [snapshot(sim.init())]
    for _ in range(chunks):
        states.append(snapshot(sim.step()))
    return sim, states


def assert_update_equal(got: dict, want, fields=("out_edges", "in_edges")):
    """An update's integer results: the named state fields and every
    counter of every rank bit-equal to JAX's."""
    for f in fields:
        np.testing.assert_array_equal(got[f], np.asarray(getattr(want, f)),
                                      err_msg=f)
    for k, v in want.stats.counters.items():
        np.testing.assert_array_equal(got["stats"]["counters"][k],
                                      np.asarray(v), err_msg=k)


def assert_chunks_match(port_states, jax_states, int_fields=()):
    """Chunk by chunk from the seed (``port_states`` as ``port_run`` gives
    them): edge tables, ``int_fields`` and every
    counter bit-equal, v, u and calcium within FLOAT_TOL, up to the first
    chunk touched by a spike near-tie (which must not be the first).
    Returns the chunks that matched."""
    chunks = len(jax_states) - 1
    for c in range(1, chunks + 1):
        got = port_states[c]
        want = jax_states[c]
        diff = {k: (np.asarray(want.stats.counters[k]).tolist(),
                    got["stats"]["counters"][k].tolist())
                for k in want.stats.counters
                if not np.array_equal(np.asarray(want.stats.counters[k]),
                                      got["stats"]["counters"][k])}
        same_spikes = np.array_equal(np.asarray(want.neurons.spike_count),
                                     got["neurons"]["spike_count"])
        if diff or not same_spikes:
            print(f"first near-tie divergence in chunk {c - 1}: {diff}")
            assert c > 1, "the first chunk differs from JAX"
            return c - 1
        for f in ("out_edges", "in_edges") + tuple(int_fields):
            np.testing.assert_array_equal(got[f],
                                          np.asarray(getattr(want, f)),
                                          err_msg=f"chunk {c}: {f}")
        for f in ("v", "u", "calcium"):
            w = np.asarray(getattr(want.neurons, f))
            err = np.abs(got["neurons"][f] - w) / np.maximum(np.abs(w), 1.0)
            assert err.max() <= FLOAT_TOL, (c, f, err.max())
    print(f"counters equal for {chunks} of {chunks} chunks")
    return chunks


def mesh_code(fields: dict, out_path: str, chunks: int = CHUNKS) -> str:
    """A script running the JAX Simulator of ``fields`` on the four host
    devices of its process, saving each chunk's edge tables and counters."""
    return textwrap.dedent(f"""
        import numpy as np
        from repro.configs.msp_brain import BrainConfig
        from repro.sim.api import Simulator
        sim = Simulator.from_config(BrainConfig(**{fields!r}))
        out = {{}}
        for c in range({chunks}):
            st = sim.step()
            out[f"out_{{c}}"] = np.asarray(st.out_edges)
            out[f"in_{{c}}"] = np.asarray(st.in_edges)
            for k, v in st.stats.counters.items():
                out[f"{{k}}_{{c}}"] = np.asarray(v)
        assert sim.num_ranks == 4, sim.num_ranks
        np.savez({out_path!r}, **out)
        print("MESH_OK")
    """)


def start_mesh(fields: dict, out_path: str):
    """``mesh_code`` in a subprocess with four host devices."""
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    return subprocess.Popen([sys.executable, "-c",
                             mesh_code(fields, out_path)],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True, env=env)


def assert_mesh_equals_vmap(mesh, path, jax_states):
    """The subprocess's JAX Simulator on four devices against the vmap
    reference: edge tables and every rank's counters after every chunk."""
    out, _ = mesh.communicate(timeout=600)
    assert mesh.returncode == 0 and "MESH_OK" in out, out
    got = np.load(path)
    for c in range(len(jax_states) - 1):
        want = jax_states[c + 1]
        np.testing.assert_array_equal(got[f"out_{c}"], want.out_edges)
        np.testing.assert_array_equal(got[f"in_{c}"], want.in_edges)
        for k, v in want.stats.counters.items():
            np.testing.assert_array_equal(got[f"{k}_{c}"], np.asarray(v),
                                          err_msg=k)


def stop(mesh):
    if mesh.poll() is None:
        mesh.kill()
        mesh.communicate()
