"""The port's checkpoints (``repro_torch.checkpoint.manager`` and
``Simulator.save`` / ``restore``) against the JAX package's: the same leaf
keys in the same file order, a JAX checkpoint restored into the port and a
port checkpoint restored into JAX, and the manager's own guarantees (atomic
keep-k, async writes of a copy the caller cannot change, crc32 on every
leaf, typed corruption errors).

Tolerances: a restored state is bitwise the saved one in both directions.
Continued from a JAX checkpoint, the port's integer results (edge tables,
every counter, the spike flags) are bit-equal to JAX's continuing, and v, u
and calcium within ``FLOAT_TOL`` x max(|x|, 1) (``_torch_ranks``).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_ranks as tr
from repro.checkpoint import manager as jmanager
from repro.configs.msp_brain import BrainConfig as JConfig
from repro.core import engine as jengine
from repro.runtime import chaos as jchaos
from repro.sim.api import Simulator as JSim
from repro_torch.checkpoint import manager
from repro_torch.configs.msp_brain import BrainConfig as TConfig
from repro_torch.core import engine as tengine
from repro_torch.runtime import chaos
from repro_torch.sim.api import Simulator

SMALL = tr.SMALL


def _cfgs(rex):
    fields = dict(SMALL, rate_exchange=rex)
    return JConfig(**fields), TConfig(**fields)


def _host(tree):
    """{key: numpy array} of a port tree (ints as int32 scalars), a copy:
    the metrics are updated in place."""
    return {k: np.array(x.detach().cpu().numpy()
                          if isinstance(x, torch.Tensor) else x,
                          np.int32 if isinstance(x, int) else None)
            for k, x in manager._flatten(tree)}


def _assert_trees_equal(a, b):
    ha, hb = _host(a), _host(b)
    assert list(ha) == list(hb)
    for k in ha:
        np.testing.assert_array_equal(ha[k], hb[k], err_msg=k)
        assert ha[k].dtype == hb[k].dtype, k


# ---------------------------------------------------------------- manager
def test_checkpoint_roundtrip_bf16_and_ints(tmp_path):
    tree = {"a": torch.arange(6, dtype=torch.bfloat16).reshape(2, 3),
            "b": {"c": torch.ones(4, dtype=torch.int32), "n": 7},
            "d": np.arange(3.0)}
    manager.save(str(tmp_path), 7, tree)
    out, manifest = manager.restore(str(tmp_path), 7, tree)
    assert manifest["step"] == 7
    assert manifest["leaves"]["a"]["dtype"] == "bfloat16"
    assert out["a"].dtype == torch.bfloat16
    assert torch.equal(out["a"], tree["a"])
    assert torch.equal(out["b"]["c"], tree["b"]["c"])
    assert out["b"]["n"] == 7 and isinstance(out["b"]["n"], int)
    np.testing.assert_array_equal(out["d"], tree["d"])


def test_bf16_crosses_between_the_packages(tmp_path):
    """A bf16 leaf written by the JAX package (ml_dtypes) restores into the
    port as torch.bfloat16, and the port's restores into JAX, bit-equal."""
    jtree = {"a": jnp.arange(6, dtype=jnp.bfloat16).reshape(2, 3) / 3}
    jmanager.save(str(tmp_path / "j"), 1, jtree)
    want = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    out, _ = manager.restore(str(tmp_path / "j"), 1,
                             {"a": torch.zeros(2, 3, dtype=torch.bfloat16)})
    assert torch.equal(out["a"], (want.to(torch.bfloat16) / 3))
    manager.save(str(tmp_path / "t"), 1, out)
    back, _ = jmanager.restore(str(tmp_path / "t"), 1, jtree)
    assert back["a"].dtype == jnp.bfloat16
    np.testing.assert_array_equal(np.asarray(back["a"], np.float32),
                                  np.asarray(jtree["a"], np.float32))


def test_checkpoint_keep_k_and_latest(tmp_path):
    tree = {"x": torch.zeros(2)}
    for s in (1, 2, 3, 4):
        manager.save(str(tmp_path), s, tree)
    manager.gc_old(str(tmp_path), keep=2)
    assert manager.latest_step(str(tmp_path)) == 4
    assert manager.steps_available(str(tmp_path)) == [3, 4]
    assert not os.path.exists(tmp_path / "step_1")
    assert manager.latest_step(str(tmp_path / "none")) is None


def test_async_checkpointer(tmp_path):
    c = manager.AsyncCheckpointer(str(tmp_path), keep=2)
    tree = {"x": torch.arange(4.0)}
    c.save(3, tree)
    c.wait()
    step, out, _ = c.restore_latest(tree)
    assert step == 3
    assert torch.equal(out["x"], torch.arange(4.0))


def test_async_checkpointer_raises_the_writers_error(tmp_path):
    blocker = tmp_path / "file"
    blocker.write_text("")
    c = manager.AsyncCheckpointer(str(tmp_path))
    c.dir = str(blocker)                   # the writer's makedirs fails
    c.save(1, {"x": torch.zeros(1)})
    with pytest.raises(OSError):
        c.wait()
    c.wait()                               # raised once


def test_async_save_then_chunks_in_place_leaves_the_files(tmp_path):
    """The simulator's metrics are updated in place: an async save followed
    at once by more chunks writes the state as it was at the save, and
    every crc32 matches the bytes written."""
    sim = Simulator.from_config(TConfig(**SMALL), device="cpu")
    sim.run(2)
    before = _host(sim.state)
    c = manager.AsyncCheckpointer(str(tmp_path))
    c.save(2, sim.state)
    sim.run(2)
    c.wait()
    arrays, manifest = manager.load_arrays(str(tmp_path), 2)
    assert list(arrays) == list(before)
    for k, v in before.items():
        np.testing.assert_array_equal(arrays[k], v, err_msg=k)
    assert sim.state.stats.counters["activity_steps"].item() == \
        4 * SMALL["rate_period"]
    assert all("crc32" in v for v in manifest["leaves"].values())


def _save_steps(tmp_path, steps):
    for s in steps:
        manager.save(str(tmp_path), s, {"a": torch.arange(4.0) + s,
                                        "b": torch.ones(2, 2) * s})
    return {"a": torch.zeros(4), "b": torch.zeros(2, 2)}


@pytest.mark.parametrize("mode", ["flip", "truncate", "manifest"])
def test_corrupt_checkpoint_raises_typed(tmp_path, mode):
    target = _save_steps(tmp_path, [1, 2])
    chaos.corrupt_checkpoint(str(tmp_path), step=2, mode=mode)
    with pytest.raises(manager.CorruptCheckpointError):
        manager.restore(str(tmp_path), 2, target)
    # restore_latest walks past the corrupt newest step
    step, tree, _ = manager.AsyncCheckpointer(str(tmp_path)).restore_latest(
        target)
    assert step == 1
    assert torch.equal(tree["a"], torch.arange(4.0) + 1)


def test_load_arrays_roundtrip_and_verify(tmp_path):
    _save_steps(tmp_path, [3])
    arrays, manifest = manager.load_arrays(str(tmp_path), 3)
    np.testing.assert_array_equal(arrays["a"], np.arange(4.0) + 3)
    assert all("crc32" in v for v in manifest["leaves"].values())
    chaos.corrupt_checkpoint(str(tmp_path), step=3, mode="flip")
    with pytest.raises(manager.CorruptCheckpointError):
        manager.load_arrays(str(tmp_path), 3)


def test_restore_checks_keys_shapes_and_dtypes(tmp_path):
    _save_steps(tmp_path, [1])
    with pytest.raises(KeyError):
        manager.restore(str(tmp_path), 1, {"z": torch.zeros(4)})
    with pytest.raises(ValueError, match="shape"):
        manager.restore(str(tmp_path), 1, {"a": torch.zeros(5)})
    with pytest.raises(ValueError, match="dtype"):
        manager.restore(str(tmp_path), 1,
                        {"a": torch.zeros(4, dtype=torch.float64)})


# ---------------------------------------------------------------- layout
@pytest.mark.parametrize("rex", ["dense", "sparse"])
def test_leaf_keys_and_file_order_match_jax(tmp_path, rex):
    """The port's keys, shapes and dtypes are the JAX state's, in the JAX
    package's file order (leaf_00000 is .neurons/.v, .chunk an int32 ())."""
    jcfg, tcfg = _cfgs(rex)
    want = jmanager._flatten(jax.eval_shape(
        lambda: jengine.init_state(jcfg, 0, 1)))[0]
    sim = Simulator.from_config(tcfg, device="cpu")
    sim.save(str(tmp_path))
    got = jmanager.read_manifest(str(tmp_path), 0)["leaves"]
    assert len(want) == len(got) == (51 if rex == "dense" else 53)
    for i, (key, leaf) in enumerate(want):
        info = got[key]
        assert info["file"] == f"leaf_{i:05d}.npy", key
        assert tuple(info["shape"]) == leaf.shape, key
        assert info["dtype"] == str(leaf.dtype), key
    assert [k for k, _ in manager._flatten(sim.state)] == [k for k, _ in want]


@pytest.mark.parametrize("rex", ["dense", "sparse"])
def test_port_checkpoint_restores_into_jax(tmp_path, rex):
    """A port checkpoint restores through the JAX manager against the JAX
    Simulator's abstract state, every leaf bitwise the port's."""
    jcfg, tcfg = _cfgs(rex)
    sim = Simulator.from_config(tcfg, device="cpu")
    sim.run(2)
    assert sim.save(str(tmp_path)) == 2
    jsim = JSim.from_config(jcfg)
    tree, manifest = jmanager.restore(str(tmp_path), 2,
                                      jax.eval_shape(jsim.init_fn))
    assert manifest["metadata"]["rate_exchange"] == rex
    want = _host(sim.state)
    got = jmanager._flatten(tree)[0]
    assert [k for k, _ in got] == list(want)
    for k, leaf in got:
        np.testing.assert_array_equal(np.asarray(leaf), want[k], err_msg=k)
        assert np.asarray(leaf).dtype == want[k].dtype, k


@pytest.fixture(scope="module")
def jax_saved(tmp_path_factory):
    """The JAX Simulator at R=1: two chunks, saved, then two more."""
    d = str(tmp_path_factory.mktemp("jax_ckpt"))
    jsim = JSim.from_config(JConfig(**SMALL))
    jsim.run(2)
    jsim.save(d)
    saved = jax.device_get(jsim.state)
    jsim.run(2)
    return d, saved, jax.device_get(jsim.state)


def test_jax_checkpoint_restores_into_the_port(jax_saved):
    """A checkpoint written by the JAX Simulator restores into the port
    bitwise; two more chunks match JAX's two more (integers bit-equal, the
    activity floats within FLOAT_TOL)."""
    d, saved, after = jax_saved
    sim = Simulator.from_config(TConfig(**SMALL), device="cpu")
    assert sim.restore(d) == 2 and sim.chunk == 2
    restored = _host(sim.state)
    for k, leaf in jmanager._flatten(saved)[0]:
        np.testing.assert_array_equal(restored[k], np.asarray(leaf),
                                      err_msg=k)
    sim.run(2)
    got = _host(sim.state)
    want = {k: np.asarray(v) for k, v in jmanager._flatten(after)[0]}
    float_keys = {f".neurons/.{f}" for f in ("v", "u", "calcium")}
    for k in want:
        if k in float_keys:
            err = np.abs(got[k] - want[k]) / np.maximum(np.abs(want[k]), 1)
            assert err.max() <= tr.FLOAT_TOL, (k, err.max())
        elif k.startswith((".stats/counters", ".neurons/.spik")) or \
                want[k].dtype != np.float32:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert sim.stats()["checkpoint_restores"] == 1


# ---------------------------------------------------------------- facade
@pytest.mark.parametrize("num_ranks", [1, 4])
@pytest.mark.parametrize("rex", ["dense", "sparse"])
def test_save_restore_roundtrip_bit_identical(tmp_path, rex, num_ranks):
    """save -> restore -> run(k) == an uninterrupted run(n + k), bitwise,
    in both exchange layouts, at one rank and at four (dist.LocalComm)."""
    cfg = TConfig(**SMALL, rate_exchange=rex)
    a = Simulator.from_config(cfg, num_ranks=num_ranks, device="cpu")
    a.run(2)
    assert a.save(str(tmp_path)) == 2
    a.run(2)
    b = Simulator.from_config(cfg, num_ranks=num_ranks, device="cpu")
    assert b.restore(str(tmp_path)) == 2
    b.run(2)
    _assert_trees_equal(a.state, b.state)
    assert a.stats()["checkpoint_saves"] == b.stats()["checkpoint_restores"]


def test_restore_missing_checkpoint_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        Simulator.from_config(TConfig(**SMALL), device="cpu").restore(
            str(tmp_path / "nope"))


def test_readouts_per_rank_and_metadata():
    """stats(reduce=False) gives each counter's (R,) per-rank values, whose
    sums are stats()'s; metrics() is the joined tree as numpy; the
    checkpoint metadata has the JAX Simulator's keys."""
    sim = Simulator.from_config(TConfig(**SMALL), num_ranks=4, device="cpu")
    sim.run(2)
    per_rank, summed = sim.stats(reduce=False), sim.stats()
    for k, v in per_rank.items():
        assert isinstance(v, np.ndarray) and v.shape == (4,)
        assert float(v.sum()) == summed[k]
    m = sim.metrics()
    assert m.per_chunk["synapses_formed"].shape == (4, SMALL.get(
        "metrics_history", 64))
    want = tengine.join_states(sim.rank_states).stats
    for part in ("counters", "per_chunk", "hists", "gauges"):
        for k, v in getattr(want, part).items():
            np.testing.assert_array_equal(getattr(m, part)[k], v.numpy())
    assert all(summed[k] == 0 for k in ("checkpoint_saves", "rollbacks",
                                        "restarts", "heartbeat_stale"))
    jsim = JSim.from_config(JConfig(**SMALL))
    assert set(sim.ckpt_metadata()) == set(jsim.ckpt_metadata())
    assert sim.ckpt_metadata()["cfg"] == sim.cfg.name


def test_corrupt_checkpoint_hook_matches_jax(tmp_path):
    """The port's corrupt_checkpoint damages the same bytes of the same
    file as the JAX package's (the first .npy, leaf_00000 = .neurons/.v)."""
    import shutil
    sim = Simulator.from_config(TConfig(**SMALL), device="cpu")
    sim.save(str(tmp_path / "saved"))
    for mode in ("flip", "truncate", "manifest"):
        for side, hook in (("t", chaos.corrupt_checkpoint),
                           ("j", jchaos.corrupt_checkpoint)):
            d = tmp_path / mode / side
            shutil.copytree(tmp_path / "saved", d)
            assert hook(str(d), mode=mode) == 0
        names = sorted(os.listdir(tmp_path / "saved" / "step_0"))
        damaged = [n for n in names if
                   (tmp_path / mode / "t" / "step_0" / n).read_bytes() !=
                   (tmp_path / "saved" / "step_0" / n).read_bytes()]
        assert damaged == ["manifest.json" if mode == "manifest"
                           else "leaf_00000.npy"]
        for n in names:
            assert (tmp_path / mode / "t" / "step_0" / n).read_bytes() == \
                (tmp_path / mode / "j" / "step_0" / n).read_bytes()
