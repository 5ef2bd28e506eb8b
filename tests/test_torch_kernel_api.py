"""The port's public kernel API (``repro_torch.kernels.ops``) against the JAX
package's (``repro.kernels.ops`` with ``interpret=True``) on the CPU, where
each port wrapper runs its plain version: K6 radix_argsort, K7 gauss_probs,
K8 fused_neuron_step, and the five wrappers of the kernels ported before.

Tolerances:
- K6: none. Every quantity is an integer: bit-equal to JAX, and to
  ``torch.sort(stable=True)`` where every key lies in the sorted bytes.
- K7: JAX's own (``tests/test_kernels.py::test_bh_gauss``): 1e-5 at
  sigma >= 0.25 and 2e-3 below, max(tol, 1e-4) on the row sums. Both sides
  use |x|^2 + |y|^2 - 2 x.y, whose cancellation near zero distance is
  amplified by exp(-d2 / sigma^2) at small sigma, and sum in other orders.
- K8: JAX's own (``test_neuron_step``): v and u 1e-3 (a 1-ulp difference
  from XLA's fused multiply-adds grows through v^2 near the threshold), the
  rest 1e-5, under 1 % of spike flags differing; the same for the port's
  ``update_activity`` + ``update_elements`` (which ``neuron_step_plain``
  applies in turn) against JAX's, with noise and a lesion.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.msp_brain import BrainConfig as JConfig
from repro.core import neuron as jneuron
from repro.core.neuron import NeuronParams as JParams
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.scenarios.populations import build_table, population
from repro_torch import convert
from repro_torch.configs.msp_brain import BrainConfig as TConfig
from repro_torch.configs.msp_brain import SMOKE_CONFIG
from repro_torch.connectome.synapses import compact
from repro_torch.connectome.traverse import _gauss
from repro_torch.core import neuron
from repro_torch.kernels import activity_fused as af
from repro_torch.kernels import bh_traverse as bt
from repro_torch.kernels import ops, ref
from repro_torch.kernels import radix_sort as rs
from repro_torch.kernels import synapse_apply as sa


def _t(x):
    return torch.from_numpy(np.array(x))


# ------------------------------------------------------------------ K6
ADVERSARIAL = {
    "all_equal": np.full(257, 123),
    "pre_sorted": np.arange(300),
    "reversed": np.arange(300)[::-1].copy(),
    "few_distinct": np.array([1, 0, 2] * 100),
    "extremes": np.array([2 ** 30 - 1, 0, 2 ** 30 - 1, 5]),
}


def _assert_argsort(keys, key_bits, torch_sort=True):
    keys = np.asarray(keys, np.int32)
    js, jo = jops.radix_argsort(jnp.asarray(keys), key_bits=key_bits,
                                interpret=True)
    ts, to = ops.radix_argsort(_t(keys), key_bits=key_bits)
    assert ts.dtype == to.dtype == torch.int32
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    if torch_sort:
        srt = torch.sort(_t(keys), stable=True)
        np.testing.assert_array_equal(to.numpy(), srt.indices.numpy())
        np.testing.assert_array_equal(ts.numpy(), srt.values.numpy())


@pytest.mark.parametrize("name", sorted(ADVERSARIAL))
@pytest.mark.parametrize("key_bits", [1, 8, 10, 30])
def test_radix_argsort_adversarial(name, key_bits):
    keys = ADVERSARIAL[name]
    passes = len(range(0, max(key_bits, 1), 8))
    _assert_argsort(keys, key_bits,
                    torch_sort=int(keys.max()) < 2 ** (8 * passes))


@pytest.mark.parametrize("key_bits", [1, 10, 30])
def test_radix_argsort_out_of_range_and_negative_keys(key_bits):
    """Keys at or above 2**key_bits sort by their low 8 * ceil(key_bits / 8)
    bits, negative keys by their two's-complement bytes (JAX only: not a
    sort of the values)."""
    rng = np.random.default_rng(key_bits)
    keys = rng.integers(-2 ** 31, 2 ** 31 - 1, 500)
    keys[:50] = rng.integers(2 ** key_bits, 2 ** key_bits + 600, 50)
    _assert_argsort(keys, key_bits, torch_sort=False)


def _onesweep(keys, key_bits, tile, schedule_seed):
    """The CUDA kernel's onesweep algorithm (``csrc/radix_argsort.cu``) in
    torch: digit counts by rows of ``ARGSORT_HIST_BLOCKS`` strided blocks,
    then per pass a stable rank of each tile's keys (8 warps of tile / 8
    keys, each with its running digit counts) and a decoupled look-back over
    (flag, count) words, the tiles publishing and resolving in a random
    order (a tile waits while a word it needs is still 0)."""
    k = torch.as_tensor(np.asarray(keys, np.int32)).to(torch.int64)
    n, passes = k.shape[0], rs._passes(key_bits)
    u = k & 0xFFFFFFFF
    tiles = -(-n // tile)
    blocks = min(tiles, rs.ARGSORT_HIST_BLOCKS)
    hist_threads = 512
    row = (torch.arange(n) % (blocks * hist_threads)) // hist_threads
    rows = torch.zeros((blocks, passes, 256), dtype=torch.int64)
    for p in range(passes):
        rows[:, p].index_put_((row, (u >> 8 * p) & 255),
                              torch.ones(n, dtype=torch.int64),
                              accumulate=True)
    rng = np.random.default_rng(schedule_seed)
    src_k, src_i = k.clone(), torch.arange(n)
    for p in range(passes):
        digit = ((src_k & 0xFFFFFFFF) >> 8 * p) & 255
        pad = tiles * tile - n
        dpad = torch.cat([digit, torch.full((pad,), 256)]).view(tiles, tile)
        onehot = torch.nn.functional.one_hot(dpad, 257)[..., :256]
        warp = onehot.view(tiles, 8, tile // 8, 256)
        rank = (warp.cumsum(2) - warp).mul(warp).sum(-1).view(tiles, tile)
        wcount = warp.sum(2)                              # (tiles, 8, 256)
        woff = wcount.cumsum(1) - wcount
        count = wcount.sum(1)                             # (tiles, 256)
        loc = count.cumsum(1) - count
        totals = rows[:, p].sum(0)
        start = totals.cumsum(0) - totals
        status = [None] * tiles          # None: 0; ("A" | "I", counts)
        before = [None] * tiles
        published = [t == 0 for t in range(tiles)]
        while any(b is None for b in before):
            t = int(rng.integers(tiles))
            if before[t] is not None:
                continue
            if not published[t]:
                status[t], published[t] = ("A", count[t]), True
                continue
            if t == 0:
                acc = start.clone()
            else:
                acc, j = torch.zeros(256, dtype=torch.int64), t - 1
                while status[j] is not None and status[j][0] == "A":
                    acc, j = acc + status[j][1], j - 1
                if status[j] is None:
                    continue                     # still waiting on tile j
                acc = acc + status[j][1]
            before[t] = acc
            status[t] = ("I", acc + count[t])
        dst_k = torch.zeros(n, dtype=torch.int64)
        dst_i = torch.zeros(n, dtype=torch.int64)
        for t in range(tiles):
            e = torch.arange(t * tile, min((t + 1) * tile, n))
            j = e - t * tile
            d = digit[e]
            w = j // (tile // 8)
            pos_in_tile = loc[t, d] + woff[t, w, d] + rank[t, j]
            dst = before[t][d] + pos_in_tile - loc[t, d]
            dst_k[dst], dst_i[dst] = src_k[e], src_i[e]
        src_k, src_i = dst_k, dst_i
    return src_k.to(torch.int32), src_i.to(torch.int32)


def _onesweep_cases():
    rng = np.random.default_rng(11)
    out = {name: keys for name, keys in ADVERSARIAL.items()}
    out["one"] = np.array([5])
    out["random_ragged"] = rng.integers(-2 ** 31, 2 ** 31 - 1, 3 * 1024 + 5)
    for m in (1023, 1025, 4095, 4097):
        out[f"one_tile_{m}"] = rng.integers(0, 2 ** 30, m)
    return out


ONESWEEP_CASES = _onesweep_cases()


@pytest.mark.parametrize("name", sorted(ONESWEEP_CASES))
@pytest.mark.parametrize("tile", [256, 1024, rs.ARGSORT_TILE])
@pytest.mark.parametrize("key_bits", [1, 8, 10, 30, 32])
def test_onesweep_emulation_equals_plain(name, tile, key_bits):
    """The kernel's algorithm, whatever order its tiles finish in, is
    bit-equal to the plain version: several tile sizes, n of 1, one tile
    +- 1, ragged, all-equal and every adversarial set, negative keys."""
    keys = ONESWEEP_CASES[name]
    want = rs.radix_argsort_plain(_t(np.asarray(keys, np.int32)),
                                  key_bits=key_bits)
    for seed in (0, 1):
        got = _onesweep(keys, key_bits, tile, schedule_seed=seed)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


# ------------------------------------------------------------------ K7
@pytest.mark.parametrize("n,m", [(64, 64), (128, 192), (100, 60), (300, 257)])
@pytest.mark.parametrize("sigma", [0.1, 0.25, 0.75])
def test_gauss_probs(n, m, sigma):
    rng = np.random.default_rng(n * 1000 + m)
    x = rng.random((n, 3), np.float32)
    y = rng.random((m, 3), np.float32)
    w = rng.random(m, np.float32) * 3
    jp, jr = jops.gauss_probs(jnp.asarray(x), jnp.asarray(y), jnp.asarray(w),
                              sigma=sigma, interpret=True)
    tp, tr = ops.gauss_probs(_t(x), _t(y), _t(w), sigma=sigma)
    tol = 1e-5 if sigma >= 0.25 else 2e-3
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=tol, atol=tol)
    rtol = max(tol, 1e-4)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=rtol,
                               atol=rtol)
    rp, rr = ref.bh_gauss_ref(_t(x), _t(y), _t(w), sigma=sigma)
    assert torch.equal(rp, tp) and torch.equal(rr, tr)


def test_gauss_probs_is_the_engine_gaussian():
    """The port's counterpart of test_kernel_engine_integration: P is the
    leaf-level probability w * _gauss(d2) of the Barnes-Hut traversal."""
    x = torch.tensor([[0.1, 0.2, 0.3]])
    y = torch.tensor([[0.15, 0.2, 0.3], [0.9, 0.9, 0.9]])
    w = torch.tensor([2.0, 1.0])
    p, _ = ops.gauss_probs(x, y, w, sigma=0.25)
    d2 = torch.sum((x[:, None] - y[None]) ** 2, -1)
    np.testing.assert_allclose(p.numpy(), (w * _gauss(d2, 0.25)).numpy(),
                               rtol=1e-5)


# ------------------------------------------------------------------ K8
def _neuron_inputs(n, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=n).astype(np.float32) * 5 - 60,
            rng.normal(size=n).astype(np.float32) * 2 - 13,
            rng.random(n, np.float32),
            rng.random(n, np.float32) * 2,
            rng.random(n, np.float32) * 2,
            rng.normal(size=n).astype(np.float32) * 5)


def _rs_ch_fs(cfg, n):
    return build_table(cfg, (population("rs", 0.5, "RS"),
                             population("ch", 0.25, "CH", target_calcium=0.4),
                             population("fs", 0.25, "FS",
                                        is_excitatory=False)), n)


def _assert_neuron_close(got, want):
    tols = {"v": 1e-3, "u": 1e-3, "ca": 1e-5, "ax": 1e-5, "de": 1e-5}
    for name, a, b in zip(["v", "u", "ca", "ax", "de", "spiked"], got, want):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape, name
        if name == "spiked":
            assert (a != b).mean() < 0.01
        else:
            np.testing.assert_allclose(a, b, rtol=tols[name],
                                       atol=tols[name], err_msg=name)


@pytest.mark.parametrize("n", [64, 131, 1000, 1031, 4096])
@pytest.mark.parametrize("hetero", [False, True])
def test_fused_neuron_step(n, hetero):
    jcfg, tcfg = JConfig(), TConfig()
    x = _neuron_inputs(n, n)
    jparams = tparams = None
    if hetero:
        t = _rs_ch_fs(jcfg, n)
        jparams = JParams(t.izh_a, t.izh_b, t.izh_c, t.izh_d, t.growth_rate,
                          t.target_calcium)
        tparams = convert.neuron_params_from_numpy(
            JParams(*(np.asarray(f) for f in jparams)), device="cpu")
    jx = [jnp.asarray(a) for a in x]
    tx = [_t(a) for a in x]
    jout = jops.fused_neuron_step(*jx, jcfg, params=jparams, interpret=True)
    tout = ops.fused_neuron_step(*tx, tcfg, params=tparams)
    assert tout[5].dtype == torch.bool
    _assert_neuron_close([o.numpy() for o in tout], jout)
    _assert_neuron_close([o.numpy() for o in tout],
                         jref.neuron_step_ref(*jx, jcfg, params=jparams))
    for a, b in zip(tout, ref.neuron_step_ref(*tx, tcfg, params=tparams)):
        assert torch.equal(a, b)


def test_neuron_params_from_numpy_carries_a_population_table():
    t = _rs_ch_fs(JConfig(), 64)
    p = convert.neuron_params_from_numpy(t, device="cpu")
    assert isinstance(p, neuron.NeuronParams)
    for f in neuron.NeuronParams._fields:
        np.testing.assert_array_equal(getattr(p, f).numpy(),
                                      np.asarray(getattr(t, f)))
    scal = convert.neuron_params_from_numpy(
        JParams(0.02, 0.2, -65.0, 8.0, 1e-3, 0.7), device="cpu")
    assert scal == neuron.NeuronParams(0.02, 0.2, -65.0, 8.0, 1e-3, 0.7)


@pytest.mark.parametrize("hetero", [False, True])
def test_update_activity_and_elements_match_jax(hetero):
    """With noise and half the neurons lesioned, against JAX's
    ``core/neuron.py`` at K8's tolerances."""
    jcfg, tcfg = JConfig(), TConfig()
    n = 1031
    x = _neuron_inputs(n, 5)
    noise = np.random.default_rng(9).normal(size=n).astype(np.float32) * 3
    alive = np.arange(n) % 2 == 0
    jparams = tparams = None
    if hetero:
        t = _rs_ch_fs(jcfg, n)
        jparams = JParams(t.izh_a, t.izh_b, t.izh_c, t.izh_d, t.growth_rate,
                          t.target_calcium)
        tparams = convert.neuron_params_from_numpy(
            JParams(*(np.asarray(f) for f in jparams)), device="cpu")
    zeros = np.zeros(n, np.float32)
    flags = np.zeros(n, bool)

    def run(mod, cfg, params, arr):
        st = mod.NeuronState(*(arr(a) for a in x[:5]), arr(flags),
                             arr(zeros), arr(zeros), arr(~flags))
        st = mod.update_activity(st, arr(x[5]), arr(noise), cfg, params,
                                 alive=arr(alive))
        st = mod.update_elements(st, cfg, params, alive=arr(alive))
        return (st.v, st.u, st.calcium, st.ax_elements, st.de_elements,
                st.spiked), st.spike_count

    got, tcount = run(neuron, tcfg, tparams, _t)
    want, jcount = run(jneuron, jcfg, jparams, jnp.asarray)
    _assert_neuron_close([a.numpy() for a in got], want)
    assert torch.equal(tcount, got[5].to(torch.float32))
    assert not bool(got[5][~_t(alive)].any())


def test_update_activity_and_elements_lesion_gates():
    """Dead neurons: no spike, v = c, u kept, elements 0 (JAX's gates)."""
    cfg = TConfig()
    n = 200
    v, u, ca, ax, de, inp = (_t(a) for a in _neuron_inputs(n, 6))
    inp = inp + 40.0                      # most neurons fire
    alive = torch.arange(n) % 2 == 0
    st = neuron.NeuronState(v, u, ca, ax, de, torch.zeros(n, dtype=bool),
                            torch.zeros(n), torch.zeros(n),
                            torch.ones(n, dtype=bool))
    a = neuron.update_elements(neuron.update_activity(
        st, inp, torch.zeros(n), cfg, alive=alive), cfg, alive=alive)
    dead = ~alive
    assert not bool(a.spiked[dead].any()) and bool(a.spiked[alive].any())
    assert bool((a.v[dead] == cfg.izh_c).all())
    assert torch.equal(a.u[dead], u[dead])
    assert not bool(a.ax_elements[dead].any())
    assert not bool(a.de_elements[dead].any())


# ---------------------------------------------- the kernels ported before
def test_ops_morton_sort_and_route_build_are_their_modules():
    rng = np.random.default_rng(1)
    pos = _t(rng.random((500, 3), np.float32))
    got = ops.morton_sort(pos, 64, leaf_level=3, n_leaf=64)
    want = rs.morton_sort(pos, 64, leaf_level=3, n_leaf=64)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    other = _t(rng.integers(-1, 300, 1000).astype(np.int32))
    mine = torch.arange(1000, dtype=torch.int32) // 8
    kw = dict(n=100, num_ranks=3, cap=50)
    got = ops.route_build(other, mine, **kw)
    want = sa.route_build(other, mine, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_ops_synapse_apply_is_its_module():
    rng = np.random.default_rng(2)
    n, s = 64, 8
    edges = compact(_t(np.where(rng.random((n, s)) < 0.5, -1,
                                rng.integers(0, 2 * n, (n, s))).astype(
                                    np.int32)))
    i32 = np.int32
    args = (edges, _t(rng.integers(0, n, 40).astype(i32)),
            _t(rng.integers(0, 2 * n, 40).astype(i32)),
            _t(rng.random(40) < 0.9), _t(rng.integers(0, n, 60).astype(i32)),
            _t(rng.integers(0, 2 * n, 60).astype(i32)),
            _t(rng.random(60) < 0.9), _t(rng.random(60, np.float32)),
            _t(rng.random(n, np.float32) * 4))
    got = ops.synapse_apply(*args)
    want = sa.synapse_apply(*args)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_ops_bh_traverse_and_activity_window_are_their_modules():
    from repro_torch.connectome import traverse
    from repro_torch.connectome import tree as ctree
    from repro_torch.core import engine
    cfg = SMOKE_CONFIG
    st = engine.init_state(cfg, 0, 1, device="cpu")
    tree = ctree.build_local_tree(st.positions, st.neurons.de_elements, 0,
                                  cfg, 1)
    stacked = traverse.stack_levels(tree.counts, tree.centroids, 0)
    q = st.positions.shape[0]
    gids = torch.arange(q, dtype=torch.int32)
    args = (stacked.counts, stacked.centroids, tree.leaf_members,
            st.positions, st.neurons.de_elements, st.positions,
            torch.zeros_like(gids), gids, torch.ones(q, dtype=torch.bool), 1,
            0)
    kw = dict(seed=cfg.seed, sizes=stacked.sizes, theta=cfg.theta,
              sigma=cfg.sigma, frontier=cfg.frontier_cap,
              n_levels=cfg.local_levels + 1)
    got = ops.bh_traverse(*args, **kw)
    want = bt.bh_traverse(*args, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, want))

    nst = st.neurons
    state = (nst.v, nst.u, nst.calcium, nst.ax_elements, nst.de_elements,
             nst.spiked, nst.spike_count)
    izh = tuple(getattr(cfg, f) for f in ("izh_a", "izh_b", "izh_c", "izh_d",
                                          "element_growth_rate",
                                          "target_calcium"))
    w = torch.full((q,), cfg.synapse_weight)
    akw = dict(seed=cfg.seed, num_steps=3, izh=izh,
               ca_consts=(cfg.calcium_decay, cfg.calcium_beta))
    aargs = (state, st.in_edges, w, torch.zeros(1, q), 5.0, 1.0, 0, 0)
    got = ops.fused_activity_window(*aargs, **akw)
    want = af.activity_window(*aargs, **akw)
    assert all(torch.equal(a, b) for a, b in zip(got[0], want[0]))
    assert torch.equal(got[1], want[1])
    assert all(torch.equal(a, b) for a, b in zip(
        got[0], ref.activity_window_ref(*aargs, **akw)[0]))
    with pytest.raises(NotImplementedError, match="item 9"):
        ops.fused_activity_window(*aargs, **akw,
                                  rate_slots=torch.zeros(1, dtype=torch.int32))

