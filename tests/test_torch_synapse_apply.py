"""K4 and K5's plain versions (repro_torch.kernels.synapse_apply) against the
JAX package's Pallas ``synapse_apply`` and ``route_build`` in interpret mode,
and the fused apply stages (``apply_impl="fused"``) against the JAX fused
stages, from the same numpy inputs.

Inputs are adversarial: duplicate (row, gid) messages, messages whose gid is
not in the row, invalid messages and requests, rows with more requests than
free slots, tied priorities, all-invalid stages, and routing past ``cap``.

Tolerance: none — every output is an integer table, a mask or an integer
count, and must be bit-equal."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.msp_brain import BrainConfig as JConfig
from repro.connectome import routing as jrouting
from repro.kernels import ops as kops
from repro.sim import registry as jregistry
from repro_torch import dist, prng
from repro_torch.configs.msp_brain import BrainConfig as TConfig
from repro_torch.connectome import routing as trouting
from repro_torch.connectome import synapses as tsyn
from repro_torch.kernels import synapse_apply as tsa
from repro_torch.sim import registry as tregistry

N, S = 48, 8


def _t(x):
    return torch.from_numpy(np.array(x))


def _apply_inputs(rng, qm=40, qr=60, crowd=False):
    """A compacted table, messages that mostly hit (a copy of a live slot,
    often duplicated), and requests; ``crowd`` sends most requests to 3
    rows."""
    edges = rng.integers(-1, 2 * N, (N, S)).astype(np.int32)
    edges[rng.random((N, S)) < 0.3] = -1
    edges[:4] = edges[4:8, :1]                    # rows of one repeated gid
    edges = np.stack([np.concatenate([r[r >= 0], r[r < 0]]) for r in edges])
    live = np.argwhere(edges >= 0)
    pick = live[rng.integers(0, len(live), qm)]
    mlid = pick[:, 0].astype(np.int32)
    mgid = edges[pick[:, 0], pick[:, 1]].astype(np.int32)
    mgid[::5] = rng.integers(0, 2 * N, mgid[::5].shape)   # gid not in row
    mgid[1::7] = mgid[0::7][:mgid[1::7].size]             # duplicates
    mlid[1::7] = mlid[0::7][:mlid[1::7].size]
    mval = rng.random(qm) < 0.8
    rows = rng.integers(0, 3, qr) if crowd else rng.integers(0, N, qr)
    rlid = rows.astype(np.int32)
    rsrc = rng.integers(0, 2 * N, qr).astype(np.int32)
    rval = rng.random(qr) < 0.85
    prio = (rng.integers(0, 6, qr) / 6).astype(np.float32)    # many ties
    vac = (rng.random(N) * 6).astype(np.float32)
    vac[:3] = 40.0                                # caps from free slots
    return edges, mlid, mgid, mval, rlid, rsrc, rval, prio, vac


def _both(args):
    want = kops.synapse_apply(*(jnp.asarray(a) for a in args),
                              interpret=True)
    before = tsa.apply_launches.count
    got = tsa.synapse_apply(*(_t(a) for a in args))
    assert tsa.apply_launches.count == before     # CPU: the plain version
    return want, got


@pytest.mark.parametrize("seed,crowd", [(0, False), (1, True), (2, True)])
def test_synapse_apply_equals_pallas_interpret(seed, crowd):
    rng = np.random.default_rng(seed)
    args = _apply_inputs(rng, crowd=crowd)
    (we, wa), (ge, ga) = _both(args)
    np.testing.assert_array_equal(np.asarray(we), ge.numpy())
    np.testing.assert_array_equal(np.asarray(wa), ga.numpy())
    assert ga.dtype == torch.bool and ga.any()
    assert (ge.numpy() != args[0]).any()
    if crowd:   # over-subscribed rows: some valid requests were refused
        assert (args[6] & ~ga.numpy()).any()


@pytest.mark.parametrize("stage", ["no_messages", "no_requests", "neither"])
def test_synapse_apply_with_a_stage_disabled(stage):
    """An all-invalid stage leaves the table as the other stage made it;
    with neither, the output is the compacted input."""
    rng = np.random.default_rng(7)
    args = list(_apply_inputs(rng, crowd=True))
    args[0] = np.where(rng.random((N, S)) < 0.3, -1, args[0]).astype(
        np.int32)                                 # holes: compact must run
    if stage in ("no_messages", "neither"):
        args[3] = np.zeros_like(args[3])
    if stage in ("no_requests", "neither"):
        args[6] = np.zeros_like(args[6])
    (we, wa), (ge, ga) = _both(args)
    np.testing.assert_array_equal(np.asarray(we), ge.numpy())
    np.testing.assert_array_equal(np.asarray(wa), ga.numpy())
    if stage == "neither":
        np.testing.assert_array_equal(
            ge.numpy(), tsyn.compact(_t(args[0])).numpy())
        assert not ga.any()


@pytest.mark.parametrize("seed", [0, 7, 12345])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("crowd", [False, True])
def test_keyed_accept_equals_jax_accept_requests(seed, masked, crowd):
    """K4's keyed mode (no priority operand, the accept key's two words) on
    CPU tensors runs ``synapse_apply_plain`` with ``request_priority``'s
    draw: bit-equal to the JAX package's ``accept_requests`` with the key
    derived from the same seed, with every request valid or a mask."""
    from repro.connectome import synapses as jsyn
    rng = np.random.default_rng(seed)
    edges, _, _, _, rlid, rsrc, rval, _, vac = _apply_inputs(
        rng, qr=300, crowd=crowd)
    edges[:3, 4:] = -1                  # room in the crowded rows
    if not masked:
        rval = np.ones_like(rval)
    words = prng.split_words(prng.fold_in_words(prng.key_words(seed + 2),
                                                9), 3)[2]
    jkey = jax.random.split(jax.random.fold_in(jax.random.key(seed + 2), 9),
                            3)[2]
    wa, wn = jsyn.accept_requests(*(jnp.asarray(a) for a in (
        rlid, rsrc, rval, vac, edges)), jkey)
    ge, ga = tsa.synapse_apply(_t(edges), None, None, None,
                               *(_t(a) for a in (rlid, rsrc, rval)), None,
                               _t(vac), key=words)
    np.testing.assert_array_equal(np.asarray(wa), ga.numpy())
    np.testing.assert_array_equal(np.asarray(wn), ge.numpy())
    assert ga.any() and (not crowd or not ga[rval].all())


def test_fused_apply_stages_equal_jax_fused_stages():
    rng = np.random.default_rng(5)
    edges, mlid, mgid, mval, rlid, rsrc, rval, _, vac = _apply_inputs(
        rng, crowd=True)
    jf = jregistry.resolve("apply", "fused")
    tf = tregistry.resolve("apply", "fused")
    tr = tregistry.resolve("apply", "reference")
    want = jf.deletion(*(jnp.asarray(a) for a in (edges, mlid, mgid, mval)),
                       interpret=True)
    got = tf.deletion(*(_t(a) for a in (edges, mlid, mgid, mval)))
    np.testing.assert_array_equal(np.asarray(want), got.numpy())
    assert torch.equal(got, tr.deletion(*(_t(a) for a in (edges, mlid, mgid,
                                                          mval))))
    jkey = jax.random.fold_in(jax.random.key(3), 9)
    tkey = prng.fold_in(prng.key(3), 9)
    wa, wn = jf.accept(*(jnp.asarray(a) for a in (rlid, rsrc, rval, vac,
                                                  edges)), jkey,
                       interpret=True)
    ga, gn = tf.accept(*(_t(a) for a in (rlid, rsrc, rval, vac, edges)),
                       tkey)
    np.testing.assert_array_equal(np.asarray(wa), ga.numpy())
    np.testing.assert_array_equal(np.asarray(wn), gn.numpy())
    ra, rn = tr.accept(*(_t(a) for a in (rlid, rsrc, rval, vac, edges)),
                       tkey)
    assert torch.equal(ga, ra) and torch.equal(gn, rn)


def _route_inputs(rng, n, num_ranks, kill_share, one_dest=False):
    edges = rng.integers(-1, n * num_ranks, (n, S)).astype(np.int32)
    if one_dest:                  # every partner on the last rank
        edges = np.where(edges >= 0, edges % n + (num_ranks - 1) * n, -1)
    kill = (edges >= 0) & (rng.random((n, S)) < kill_share)
    flat_other = np.where(kill, edges, -1).reshape(-1).astype(np.int32)
    flat_mine = np.broadcast_to(np.arange(n, dtype=np.int32)[:, None],
                                (n, S)).reshape(-1).copy()
    return flat_other, flat_mine


@pytest.mark.parametrize("num_ranks,lesions,kill_share,one_dest",
                         [(1, False, 0.5, False), (1, True, 1.0, False),
                          (4, False, 0.5, False), (64, False, 1.0, True),
                          (1, False, 0.0, False)])
def test_route_build_equals_pallas_interpret(num_ranks, lesions, kill_share,
                                             one_dest):
    """Buffers and drop count equal; the non-lesion cap n//4 is exceeded, so
    the drop path runs: at R = 1 and 4, and at R = 64 with every entry to
    one destination. With no entry killed nothing is dropped."""
    n = 40
    rng = np.random.default_rng(num_ranks + int(lesions))
    flat_other, flat_mine = _route_inputs(rng, n, num_ranks, kill_share,
                                          one_dest)
    cap = jrouting.cap_deletions(JConfig(neurons_per_rank=n, max_synapses=S),
                                 lesions)
    assert cap == trouting.cap_deletions(
        TConfig(neurons_per_rank=n, max_synapses=S), lesions)
    wb, wd = kops.route_build(jnp.asarray(flat_other),
                              jnp.asarray(flat_mine), n=n,
                              num_ranks=num_ranks, cap=cap, interpret=True)
    before = tsa.route_launches.count
    gb, gd = tsa.route_build(_t(flat_other), _t(flat_mine), n=n,
                             num_ranks=num_ranks, cap=cap)
    assert tsa.route_launches.count == before
    np.testing.assert_array_equal(np.asarray(wb), gb.numpy())
    np.testing.assert_array_equal(np.asarray(wd), gd.numpy())
    assert gd.shape == (1,) and gd.dtype == torch.float32
    if kill_share == 0:
        assert float(gd[0]) == 0 and (gb == -1).all()
    elif not lesions:
        assert float(gd[0]) > 0


def test_fused_route_equals_reference_route_and_refuses_ranks():
    """Both apply lowerings' deletion routing, at one rank and at four
    (``dist.LocalComm``; it was refused before multi-rank was ported): the
    received messages and drop counts agree, and at four ranks every
    received message names one of the receiver's rows."""
    n = 40
    rng = np.random.default_rng(3)
    cfg = TConfig(neurons_per_rank=n, max_synapses=S)
    tf = tregistry.resolve("apply", "fused")
    tr = tregistry.resolve("apply", "reference")
    for ranks in (1, 4):
        edges = [rng.integers(-1, ranks * n, (n, S)).astype(np.int32)
                 for _ in range(ranks)]
        kill = [_t((e >= 0) & (rng.random((n, S)) < 0.5)) for e in edges]
        for lesions in (False, True):
            got = {}
            for name, impl in (("fused", tf), ("reference", tr)):
                group = dist.LocalComm(ranks)
                got[name] = group.run([
                    lambda r=r, impl=impl: impl.route(
                        kill[r], _t(edges[r]),
                        r * n + torch.arange(n, dtype=torch.int32)[:, None],
                        cfg, group.comm(r), lesions)
                    for r in range(ranks)])
            for r, (a, b) in enumerate(zip(got["fused"], got["reference"])):
                assert torch.equal(a[0], b[0]) and float(a[1]) == float(b[1])
                live = a[0][:, 0] >= 0
                assert bool(((a[0][live, 0] // n) == r).all())
            sent = sum(int(k.sum()) for k in kill)
            kept = sum(int((a[0][:, 0] >= 0).sum()) for a in got["fused"])
            dropped = sum(float(a[1]) for a in got["fused"])
            assert kept + dropped == sent and kept > 0
