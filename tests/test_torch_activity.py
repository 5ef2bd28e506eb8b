"""K1's plain version (repro_torch.kernels.activity_fused) against the JAX
Pallas megakernel in interpret mode, from an injected state, with mixed
populations, a (4, n) rates table and rank 1 (so both the local-spike and
the remote-Bernoulli paths run).

Tolerance: XLA:CPU contracts multiply-adds and has its own log/log1p/cos,
so floats agree to a few ulp per step, not bitwise. Spike flags and counts
must be equal except at counted near-ties (|v - 30| < 1e-3 at the flip; the
remote draws are bit-equal hashes against equal rates, so they never tie);
v, u, ca, ax, de must be within 1e-5 relative up to the first flip, relative
to the larger of the value before and after the step (a step that takes v
from -44 to 0.7 cancels most of its digits)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.msp_brain import BrainConfig as JConfig
from repro.kernels.activity_fused import activity_window as jax_window
from repro.scenarios.populations import build_table, population
from repro_torch.kernels import activity_fused as taf

N, S, R, RANK, CHUNK, T = 96, 8, 4, 1, 2, 40
CFG = JConfig()
NAMES = ("v", "u", "ca", "ax", "de", "spiked", "count")


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    state = (rng.normal(-60, 5, N).astype(np.float32),
             rng.normal(-13, 2, N).astype(np.float32),
             rng.random(N, dtype=np.float32),
             (rng.random(N, dtype=np.float32) * 2),
             (rng.random(N, dtype=np.float32) * 2),
             rng.random(N) < 0.15,
             np.zeros(N, np.float32))
    edges = rng.integers(-1, R * N, (N, S)).astype(np.int32)
    rates = (rng.random((R, N), dtype=np.float32) * 0.2)
    t = build_table(CFG, (population("rs", 0.5, "RS"),
                          population("ch", 0.25, "CH", target_calcium=0.4),
                          population("fs", 0.25, "FS", is_excitatory=False)),
                    N)
    izh = tuple(np.asarray(x) for x in (t.izh_a, t.izh_b, t.izh_c, t.izh_d,
                                        t.growth_rate, t.target_calcium))
    return state, edges, np.asarray(t.synapse_weight), rates, izh


def _kw(izh, steps):
    return dict(seed=CFG.seed, num_steps=steps, izh=izh,
                ca_consts=(CFG.calcium_decay, CFG.calcium_beta))


@jax.jit
def _jax_step(st, edges, w, rates, izh, gstep):
    return jax_window(st, edges, w, rates, 5.0, 1.0, gstep, RANK,
                      interpret=True, **_kw(izh, 1))


def _torch(x):
    return torch.from_numpy(np.array(x))


def _flip_is_near_tie(v_j, v_t):
    """A flipped neuron is a near-tie if the side that did not fire kept a v
    within 1e-3 of the threshold (the side that fired was reset)."""
    return min(abs(float(v_j) - 30.0), abs(float(v_t) - 30.0)) < 1e-3


def _rel_err(a, b, before):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    scale = np.maximum(np.maximum(np.abs(a), np.abs(np.asarray(before))), 1.0)
    return np.abs(a - b) / scale


def test_one_window_step_synced_against_pallas_interpret():
    """Each step starts both versions from the reference's state: flags and
    counts equal except counted near-ties, floats within 1e-5 relative."""
    state, edges, w, rates, izh = _inputs()
    st = tuple(jnp.asarray(x) for x in state)
    izh_j = tuple(jnp.asarray(x) for x in izh)
    izh_t = tuple(_torch(x) for x in izh)
    near_ties, worst = 0, 0.0
    for t in range(T):
        gstep = CHUNK * T + t
        (out_j, spk_j) = _jax_step(st, jnp.asarray(edges), jnp.asarray(w),
                                   jnp.asarray(rates), izh_j, gstep)
        out_j = jax.device_get(out_j)
        out_t, spk_t = taf.activity_window(
            tuple(_torch(x) for x in jax.device_get(st)), _torch(edges),
            _torch(w), _torch(rates), 5.0, 1.0, gstep, RANK, **_kw(izh_t, 1))
        flip = np.asarray(out_j[5]) != out_t[5].numpy()
        for i in np.flatnonzero(flip):
            assert _flip_is_near_tie(out_j[0][i], out_t[0][i]), \
                f"step {t} neuron {i}"
        near_ties += int(flip.sum())
        same = ~flip
        for name, a, b, x in zip(NAMES[:5], out_j[:5], out_t[:5], st[:5]):
            rel = _rel_err(a, b.numpy(), x)[same]
            worst = max(worst, float(rel.max()))
            assert rel.max() <= 1e-5, (name, t)
        np.testing.assert_array_equal(np.asarray(out_j[6])[same],
                                      out_t[6].numpy()[same])
        st = tuple(jnp.asarray(x) for x in out_j)
    assert near_ties <= 0.01 * N * T
    print(f"step-synced: {near_ties} near-tie flips, worst rel {worst:.2e}")


def _jax_full_window(state, edges, w, rates, izh):
    return jax.jit(lambda st: jax_window(
        st, jnp.asarray(edges), jnp.asarray(w), jnp.asarray(rates), 5.0, 1.0,
        CHUNK, RANK, interpret=True,
        **_kw(tuple(jnp.asarray(x) for x in izh), T)))(
        tuple(jnp.asarray(x) for x in state))


def test_one_window_free_running_until_first_flip():
    """The whole window in one call each: per-step fired counts equal up to
    the first step whose flags differ (reported). Free-running, the few-ulp
    per-step differences compound through the expansive upswing of the
    Izhikevich map (a 4-ulp nudge of the input v and u moves the reference
    itself by ~5e-4 relative over these 40 steps, printed beside the port's
    drift), so free-running floats are held to 1e-2 relative only; the
    step-synced test above holds every single step to 1e-5."""
    state, edges, w, rates, izh = _inputs(seed=1)
    want, want_spk = _jax_full_window(state, edges, w, rates, izh)
    def nudge(x):
        for _ in range(4):
            x = np.nextafter(x, np.float32(np.inf))
        return x
    ref2, _ = _jax_full_window((nudge(state[0]), nudge(state[1]))
                               + state[2:], edges, w, rates, izh)
    got, got_spk = taf.activity_window(
        tuple(_torch(x) for x in state), _torch(edges), _torch(w),
        _torch(rates), 5.0, 1.0, CHUNK, RANK,
        **_kw(tuple(_torch(x) for x in izh), T))
    assert got_spk.shape == (T,) and got_spk.dtype == torch.float32
    ws, gs = np.asarray(want_spk), got_spk.numpy()
    diff = np.flatnonzero(ws != gs)
    first = int(diff[0]) if diff.size else T
    print(f"free-running window: first differing step {first} of {T}")
    np.testing.assert_array_equal(ws[:first], gs[:first])
    assert float(gs.sum()) > 0, "window produced no spikes at all"
    if first == T and np.array_equal(np.asarray(want[5]),
                                     np.asarray(ref2[5])):
        np.testing.assert_array_equal(np.asarray(want[5]), got[5].numpy())
        np.testing.assert_array_equal(np.asarray(want[6]), got[6].numpy())
        for name, a, b, r, x in zip(NAMES[:5], want[:5], got[:5], ref2[:5],
                                    state[:5]):
            err = _rel_err(a, b.numpy(), x).max()
            own = _rel_err(a, np.asarray(r), x).max()
            print(f"  {name}: port {err:.2e}, reference 4-ulp nudge "
                  f"{own:.2e}")
            assert err <= 1e-2, name


@pytest.mark.parametrize("steps", [1, 7])
def test_fused_wrapper_on_cpu_is_the_plain_window(steps):
    state, edges, w, rates, izh = _inputs(seed=2)
    args = (tuple(_torch(x) for x in state), _torch(edges), _torch(w),
            _torch(rates), 5.0, 1.0, CHUNK, RANK)
    kw = _kw(tuple(_torch(x) for x in izh), steps)
    before = taf.launches.count
    a, a_spk = taf.activity_window(*args, **kw)
    b, b_spk = taf.window_plain(*args, **kw)
    assert taf.launches.count == before
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert torch.equal(a_spk, b_spk)


def test_window_refuses_what_the_slice_does_not_carry():
    """The sparse rate view is refused; the scenario tables are carried."""
    state, edges, w, rates, izh = _inputs()
    args = (tuple(_torch(x) for x in state), _torch(edges), _torch(w),
            _torch(rates), 5.0, 1.0, 0, RANK)
    kw = _kw(tuple(_torch(x) for x in izh), 2)
    with pytest.raises(NotImplementedError, match="sparse"):
        taf.activity_window(*args, rate_slots=_torch(edges), **kw)
    stim, lesions = _scenario_tables(np.random.default_rng(9), 0)
    a, _ = taf.activity_window(*args, stim=_torch_tables(stim),
                               lesions=_torch_tables(lesions), **kw)
    b, _ = taf.window_plain(*args, stim=_torch_tables(stim),
                            lesions=_torch_tables(lesions), **kw)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.parametrize("events", [False, True])
def test_fused_wrapper_on_cpu_leaves_its_inputs_unchanged(events):
    """The window returns new tensors: the state, rows, rates and event
    tables it was given hold the same values after the call."""
    state, edges, w, rates, izh = _inputs(seed=4)
    ins = (tuple(_torch(x) for x in state), _torch(edges), _torch(w),
           _torch(rates))
    copies = (tuple(x.clone() for x in ins[0]),
              *(x.clone() for x in ins[1:]))
    kw = _kw(tuple(_torch(x) for x in izh), 3)
    if events:
        stim, lesions = _scenario_tables(np.random.default_rng(9), CHUNK * 3)
        kw.update(stim=_torch_tables(stim), lesions=_torch_tables(lesions))
    evs = [kw[k] for k in ("stim", "lesions") if k in kw]
    masks = [e[0].clone() for e in evs]
    out, _ = taf.activity_window(*ins, 5.0, 1.0, CHUNK, RANK, **kw)
    for x, y in zip(ins[0], copies[0]):
        assert torch.equal(x, y)
    for x, y in zip(ins[1:], copies[1:]):
        assert torch.equal(x, y)
    for e, m in zip(evs, masks):
        assert torch.equal(e[0], m)
    assert not any(o is x for o, x in zip(out, ins[0]))


def _scenario_tables(rng, t0):
    """Two stimulus events and two lesion windows over random masks; the
    windows open and close at t0 + 2, t0 + 3 and t0 + 5."""
    masks = rng.random((3, N)) < 0.4
    stim = (masks[:2].astype(np.float32),
            ((4.0, t0 + 2, t0 + 5), (-2.5, t0 - 10, t0 + 3)))
    lesions = (masks[1:], ((t0 + 3, 1 << 30), (0, t0 + 2)))
    return stim, lesions


def _torch_tables(table):
    return (_torch(table[0]), table[1])


def _jax_tables(table):
    return (jnp.asarray(table[0]), table[1])


@pytest.mark.parametrize("seed", [0, 1])
def test_steps_with_stimulus_and_lesions_against_jax_step_core(seed):
    """step_core with the protocol tables against the JAX step_core, each
    step from the reference's state, across windows that open and close
    mid-window. Lesion-gated values are exact: a dead neuron's flag is
    False, v equals c, u is the value before the step, ax = de = 0; the
    rest is held to the tolerance of the step-synced test above."""
    from repro.kernels.activity_fused import step_core as jax_step_core
    state, edges, w, rates, izh = _inputs(seed=seed)
    rng = np.random.default_rng(seed + 20)
    g0 = CHUNK * T
    stim, lesions = _scenario_tables(rng, g0)
    izh_j = tuple(jnp.asarray(x) for x in izh)
    izh_t = tuple(_torch(x) for x in izh)
    ca = (CFG.calcium_decay, CFG.calcium_beta)
    jstep = jax.jit(lambda st, g: jax_step_core(
        st, jnp.asarray(edges), jnp.asarray(w), jnp.asarray(rates), 5.0,
        1.0, izh_j, ca, CFG.seed, g, RANK, N, stim=_jax_tables(stim),
        lesions=_jax_tables(lesions)))
    st = tuple(jnp.asarray(x) for x in state)
    near_ties = dead_seen = 0
    for t in range(8):
        g = g0 + t
        want = jax.device_get(jstep(st, jnp.int32(g)))
        before = tuple(np.asarray(x) for x in jax.device_get(st))
        got = taf.step_core(tuple(_torch(x) for x in before), _torch(edges),
                            _torch(w), _torch(rates), 5.0, 1.0, izh_t, ca,
                            CFG.seed, g, RANK, N,
                            stim=_torch_tables(stim),
                            lesions=_torch_tables(lesions))
        dead = np.zeros(N, bool)
        for m, (t0, t1) in zip(lesions[0], lesions[1]):
            dead |= m & (t0 <= g < t1)
        dead_seen += int(dead.sum())
        got = tuple(x.numpy() for x in got)
        for x in (want, got):
            assert not x[5][dead].any()
            np.testing.assert_array_equal(x[0][dead], izh[2][dead])
            np.testing.assert_array_equal(x[1][dead], before[1][dead])
            assert not x[3][dead].any() and not x[4][dead].any()
        flip = np.asarray(want[5]) != got[5]
        for i in np.flatnonzero(flip):
            assert _flip_is_near_tie(want[0][i], got[0][i]), (t, i)
        near_ties += int(flip.sum())
        same = ~flip
        for name, a, b, x in zip(NAMES[:5], want[:5], got[:5], before[:5]):
            assert _rel_err(a, b, x)[same].max() <= 1e-5, (name, t)
        st = tuple(jnp.asarray(x) for x in want)
    assert dead_seen > 0 and near_ties <= 0.01 * N * 8


def test_spike_helpers_match_reference():
    """core/spikes: local hits and remote Bernoulli reconstruction (the
    pieces step_core sums) equal the reference's, edge for edge."""
    from repro.core import spikes as jspikes
    from repro_torch.core import spikes as tspikes
    state, edges, w, rates, izh = _inputs(seed=3)
    spiked = state[5]
    np.testing.assert_array_equal(
        np.asarray(jspikes.local_spikes(jnp.asarray(spiked),
                                        jnp.asarray(edges), RANK, N)),
        tspikes.local_spikes(_torch(spiked), _torch(edges), RANK, N).numpy())
    for gstep in (0, 201, 2 ** 20):
        want = np.asarray(jspikes.reconstruct_spikes(
            CFG.seed, gstep, jnp.asarray(rates), jnp.asarray(edges), RANK, N))
        got = tspikes.reconstruct_spikes(CFG.seed, gstep, _torch(rates),
                                         _torch(edges), RANK, N).numpy()
        np.testing.assert_array_equal(want, got)
        assert got.any()
    np.testing.assert_array_equal(
        tspikes.exchange_rates(_torch(rates[0]), 1).numpy(), rates[:1])
