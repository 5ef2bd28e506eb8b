"""The paper's OLD spike exchange (``spike_alg="old"``: every step the ranks
all-gather their sorted spiked IDs and binary-search each remote in-edge)
and the building blocks of the sparse rate exchange, in the port against
the JAX package.

- ``exchange_spiked_ids``, ``lookup_spikes``, ``build_subscriptions`` (with
  and without overflow) and ``push_subscribed_rates`` on seeded numpy
  inputs, at R=1 and R=4 (JAX under ``jax.vmap`` with the ``ranks`` axis,
  the port through ``dist.LocalComm``): bit-equal.
- K1's plain window with the sparse operand (``rate_slots``) against the
  JAX Pallas kernel in interpret mode, step-synced: spike flags and counts
  equal except counted near-ties (|v - 30| < 1e-3), v, u, ca, ax, de within
  1e-5 relative, the tolerance of ``test_torch_activity.py``.
- The old spike path from the seed at R=1 and R=4, one injected update and
  three chunks: the tolerances of ``_torch_ranks`` (edge tables and every
  counter, ``spikes_sent`` among them, bit-equal; v, u, calcium within 2e-3
  x max(|x|, 1)).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_ranks as tr
from repro.configs.msp_brain import BrainConfig as JConfig
from repro.connectome import routing as jrouting
from repro.core import spikes as jspikes
from repro.kernels.activity_fused import activity_window as jax_window
from repro.scenarios.populations import build_table, population
from repro_torch import dist
from repro_torch.connectome import routing as trouting
from repro_torch.core import spikes as tspikes
from repro_torch.kernels import activity_fused as taf

OLD_SPIKES = dict(tr.SMALL, spike_alg="old")
N, S, R = 64, 8, 4


def _t(x):
    return torch.from_numpy(np.array(x))


def _vmap(fn, *per_rank):
    """``fn(rank, *args)`` over R ranks under ``jax.vmap`` with the
    ``ranks`` axis; ``per_rank`` arrays stacked on axis 0."""
    return jax.device_get(jax.jit(jax.vmap(
        lambda *a: fn(jax.lax.axis_index("ranks"), *a),
        axis_name="ranks"))(*(jnp.asarray(np.stack(a)) for a in per_rank)))


def _local(num_ranks, fn, *per_rank):
    """``fn(comm, *args)`` on every rank of a ``dist.LocalComm``."""
    group = dist.LocalComm(num_ranks)
    return group.run([lambda r=r: fn(group.comm(r), *(_t(a[r])
                                                        for a in per_rank))
                      for r in range(num_ranks)])


def _random_edges(rng, num_ranks, empty=0.3):
    e = rng.integers(0, num_ranks * N, (N, S)).astype(np.int32)
    return np.where(rng.random((N, S)) < empty, -1, e).astype(np.int32)


@pytest.mark.parametrize("num_ranks", [1, 4])
def test_exchange_and_lookup_of_spiked_ids_bit_equal(num_ranks):
    """The sorted, padded spiked-ID lists every rank receives, the counts,
    and each rank's binary-search hits over its random in-edges."""
    rng = np.random.default_rng(10 + num_ranks)
    spiked = rng.random((num_ranks, N)) < 0.2
    edges = np.stack([_random_edges(rng, num_ranks)
                      for _ in range(num_ranks)])

    def jfn(rank, sp, ed):
        ids, counts = jspikes.exchange_spiked_ids(sp, rank, N, "ranks",
                                                  num_ranks)
        return ids, counts, jspikes.lookup_spikes(ids, ed, N)

    want = _vmap(jfn, spiked, edges)

    def tfn(comm, sp, ed):
        ids, counts = tspikes.exchange_spiked_ids(sp, comm.rank, N, comm)
        return ids, counts, tspikes.lookup_spikes(ids, ed, N)

    got = _local(num_ranks, tfn, spiked, edges)
    for r, (ids, counts, hits) in enumerate(got):
        np.testing.assert_array_equal(ids.numpy(), want[0][r])
        np.testing.assert_array_equal(counts.numpy(), want[1][r])
        np.testing.assert_array_equal(hits.numpy(), want[2][r])
        assert hits.any()


@pytest.mark.parametrize("n_ids", [1, 7, 64, 1000])
def test_lookup_spikes_on_lists_of_any_length_bit_equal(n_ids):
    """The explicit binary search on sorted lists of ``n_ids`` entries
    (pads at int32 max), sources present, absent and empty."""
    rng = np.random.default_rng(n_ids)
    lists = np.sort(np.where(rng.random((R, n_ids)) < 0.6,
                             rng.integers(0, R * N, (R, n_ids)),
                             tspikes.NO_SUB), axis=1).astype(np.int32)
    edges = _random_edges(rng, R)
    want = np.asarray(jspikes.lookup_spikes(jnp.asarray(lists),
                                            jnp.asarray(edges), N))
    got = tspikes.lookup_spikes(_t(lists), _t(edges), N).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("subs_cap,empty", [(512, 0.3), (40, 0.3), (32, 0.0),
                                            (200, 1.0)])
def test_build_subscriptions_bit_equal(subs_cap, empty):
    """The registry, the edge -> slot remap and the overflow count of a rank
    from a random in-edge table: with room, overflowing (40 and 32 slots for
    about 150 unique remote sources), and with an empty table."""
    rng = np.random.default_rng(subs_cap)
    edges = _random_edges(rng, R, empty)
    want = jax.device_get(jspikes.build_subscriptions(jnp.asarray(edges), 1,
                                                      N, subs_cap))
    got = tspikes.build_subscriptions(_t(edges), 1, N, subs_cap)
    for a, b, name in zip(got, want, ("subs", "rate_slots", "overflow")):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)
    assert (float(got[2]) > 0) == (subs_cap < 64 and empty < 1.0)


@pytest.mark.parametrize("num_ranks", [1, 4])
def test_push_subscribed_rates_bit_equal(num_ranks):
    """Every rank's registry pushed to the owners and the subscribed rates
    brought back: the (subs_cap,) rate buffer and the pushed count."""
    rng = np.random.default_rng(20 + num_ranks)
    cap = 96
    edges = np.stack([_random_edges(rng, num_ranks, 0.5)
                      for _ in range(num_ranks)])
    rates = rng.random((num_ranks, N), dtype=np.float32)
    subs = np.stack([np.asarray(jspikes.build_subscriptions(
        jnp.asarray(edges[r]), r, N, cap)[0]) for r in range(num_ranks)])

    def jfn(rank, sb, rt):
        return jrouting.push_subscribed_rates(sb, rt, "ranks", num_ranks, N)

    want = _vmap(jfn, subs, rates)
    got = _local(num_ranks, lambda comm, sb, rt:
                 trouting.push_subscribed_rates(sb, rt, comm, N), subs, rates)
    for r, (remote, pushed) in enumerate(got):
        np.testing.assert_array_equal(remote.numpy(), want[0][r])
        assert float(pushed) == float(want[1][r])
    if num_ranks > 1:
        assert any(bool((g[0] > 0).any()) for g in got)


# ------------------------------------------------------------ K1 sparse
def _window_inputs(seed=0, rank=1):
    rng = np.random.default_rng(seed)
    state = (rng.normal(-60, 5, N).astype(np.float32),
             rng.normal(-13, 2, N).astype(np.float32),
             rng.random(N, dtype=np.float32),
             rng.random(N, dtype=np.float32) * 2,
             rng.random(N, dtype=np.float32) * 2,
             rng.random(N) < 0.15, np.zeros(N, np.float32))
    edges = _random_edges(rng, R, 0.1)
    subs, slots, _ = jspikes.build_subscriptions(jnp.asarray(edges), rank, N,
                                                 160)
    buf = np.where(np.asarray(subs) != jspikes.NO_SUB,
                   rng.random(160, dtype=np.float32) * 0.3, 0.0)
    t = build_table(JConfig(), (population("rs", 0.5, "RS"),
                                population("fs", 0.5, "FS",
                                           is_excitatory=False)), N)
    izh = tuple(np.asarray(x) for x in (t.izh_a, t.izh_b, t.izh_c, t.izh_d,
                                        t.growth_rate, t.target_calcium))
    return (state, edges, np.asarray(t.synapse_weight),
            buf.astype(np.float32), np.asarray(slots), izh)


def _kw(izh, steps):
    cfg = JConfig()
    return dict(seed=cfg.seed, num_steps=steps, izh=izh,
                ca_consts=(cfg.calcium_decay, cfg.calcium_beta))


@jax.jit
def _jax_step(st, edges, w, rates, slots, izh, gstep):
    return jax_window(st, edges, w, rates, 5.0, 1.0, gstep, 1,
                      rate_slots=slots, interpret=True, **_kw(izh, 1))


def test_window_with_rate_slots_step_synced_against_pallas_interpret():
    """K1's plain window reading the compact rate buffer through the slot
    remap, one step at a time from the reference's state: flags and counts
    equal except counted near-ties, floats within 1e-5 relative, and remote
    spikes drawn (the buffer's rates reach the neurons)."""
    state, edges, w, buf, slots, izh = _window_inputs()
    st = tuple(jnp.asarray(x) for x in state)
    izh_j = tuple(jnp.asarray(x) for x in izh)
    near_ties = 0
    steps = 30
    for t in range(steps):
        gstep = 2 * steps + t
        out_j, _ = _jax_step(st, jnp.asarray(edges), jnp.asarray(w),
                             jnp.asarray(buf), jnp.asarray(slots), izh_j,
                             gstep)
        out_j = jax.device_get(out_j)
        out_t, _ = taf.activity_window(
            tuple(_t(x) for x in jax.device_get(st)), _t(edges), _t(w),
            _t(buf), 5.0, 1.0, gstep, 1, rate_slots=_t(slots),
            **_kw(tuple(_t(x) for x in izh), 1))
        flip = np.asarray(out_j[5]) != out_t[5].numpy()
        for i in np.flatnonzero(flip):
            assert min(abs(float(out_j[0][i]) - 30.0),
                       abs(float(out_t[0][i]) - 30.0)) < 1e-3
        near_ties += int(flip.sum())
        same = ~flip
        for a, b, x in zip(out_j[:5], out_t[:5], st[:5]):
            a, x = np.asarray(a, np.float64), np.asarray(x, np.float64)
            scale = np.maximum(np.maximum(np.abs(a), np.abs(x)), 1.0)
            rel = (np.abs(a - b.numpy()) / scale)[same]
            assert rel.max() <= 1e-5, t
        st = tuple(jnp.asarray(x) for x in out_j)
    assert near_ties <= 0.01 * N * steps
    remote = taf.reconstruct_remote_spikes(0, 2 * steps, _t(buf), _t(edges),
                                           1, N, rate_slots=_t(slots))
    assert remote.any()


# ------------------------------------------------------------ old spikes
@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    """The JAX reference of the old spike path: three chunks from the seed
    at R=1 and R=4, the vmapped update from the state after chunk 2, and
    the JAX Simulator on four host devices in a subprocess."""
    path = str(tmp_path_factory.mktemp("mesh") / "mesh.npz")
    mesh = tr.start_mesh(OLD_SPIKES, path)
    runs = {r: tr.jax_run(OLD_SPIKES, r) for r in (1, 4)}
    updates = {r: tr.jax_update(OLD_SPIKES, r, runs[r][1][2]) for r in (1, 4)}
    yield {"runs": runs, "updates": updates, "mesh": (mesh, path)}
    tr.stop(mesh)


@pytest.mark.parametrize("num_ranks", [1, 4])
def test_three_old_spike_chunks_from_the_seed_against_jax(jax_ref,
                                                          num_ranks):
    """Three chunks with the per-step spiked-ID exchange from the seed:
    per chunk the edge tables and every rank's counters (``spikes_sent``
    counted every step, no ``rates_sent``) equal to JAX's, the activity
    floats within FLOAT_TOL; health 0."""
    fields = dict(OLD_SPIKES, connectivity_impl="fused", tree_impl="fused",
                  apply_impl="fused")
    sim, states = tr.port_run(fields, num_ranks)
    tr.assert_chunks_match(states, jax_ref["runs"][num_ranks][0],
                           ("rates_table",))
    stats = sim.stats()
    assert sim.health()["health_flags"] == 0.0
    assert stats["spikes_sent"] > 0 and stats["rates_sent"] == 0


@pytest.mark.parametrize("num_ranks", [1, 4])
def test_old_spike_update_skips_the_rate_exchange(jax_ref, num_ranks):
    """Under the old spike algorithm the connectivity update leaves the
    rates table as it was and counts no rate record, as the reference."""
    before = jax_ref["runs"][num_ranks][0][2]
    got = tr.port_update(OLD_SPIKES, num_ranks, before)
    tr.assert_update_equal(got, jax_ref["updates"][num_ranks],
                           ("out_edges", "in_edges", "rates_table"))
    np.testing.assert_array_equal(got["rates_table"], before.rates_table)
    assert (got["stats"]["counters"]["rates_sent"]
            == np.asarray(before.stats.counters["rates_sent"])).all()


def test_old_spike_window_is_one_collective_a_step():
    """Each rank reaches exactly one collective a step of the window (the
    spiked-ID all-gather), in the same order on every rank."""
    from repro_torch.configs.msp_brain import BrainConfig as TConfig
    from repro_torch.core import engine as tengine
    from repro_torch.sim import phases as tphases
    cfg = TConfig(**OLD_SPIKES)
    group = dist.LocalComm(R)
    calls = [0] * R

    class Counting(dist.Comm):
        def __init__(self, inner):
            self.inner, self.rank, self.num_ranks = inner, inner.rank, R

        def all_gather(self, x):
            calls[self.rank] += 1
            return self.inner.all_gather(x)

    ctxs = [tphases.make_context(cfg, r, R, device="cpu",
                                 comm=Counting(group.comm(r)))
            for r in range(R)]
    states = [tengine.init_state(cfg, r, R, device="cpu") for r in range(R)]
    group.run([lambda r=r: tphases.activity_phase(states[r], ctxs[r])
               for r in range(R)])
    assert calls == [cfg.rate_period] * R


def test_vmap_reference_equals_the_mesh(jax_ref):
    """The vmap reference of the old spike path against the JAX Simulator
    on four host devices: edge tables and every rank's counters equal after
    every chunk."""
    tr.assert_mesh_equals_vmap(*jax_ref["mesh"], jax_ref["runs"][4][0])
