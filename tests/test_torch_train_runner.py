"""The port's TrainingRunner and training driver, against the JAX
package's where they meet.

The runner rolls back a NaN (the poisoned batch consumed), stops on
preemption with a checkpoint, and resumes bitwise (the JAX package's
``tests/test_substrate.py`` runner tests, and a resume of the smoke model);
a ``{"params", "opt"}`` checkpoint either package's runner writes is
restored by the other's, leaf for leaf. The counterpart of the JAX
package's ``test_training_loss_decreases_end_to_end``: 80 steps of the
qwen2-7b smoke model through ``build_everything`` drop the loss by more
than 0.15; and ``python -m repro_torch.launch.train --smoke --device cpu``
runs its 20 steps."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.optim import optimizer as jopt
from repro.runtime import fault_tolerance as jft
from repro_torch.checkpoint.manager import AsyncCheckpointer
from repro_torch.configs import get_smoke_config
from repro_torch.data.pipeline import DataConfig, TokenPipeline
from repro_torch.launch import train as ttrain
from repro_torch.optim.optimizer import leaves
from repro_torch.runtime import fault_tolerance as tft


class _Ones:
    def __init__(self):
        self.i = 0

    def __next__(self):
        self.i += 1
        return {"x": torch.ones(2)}


def test_runner_nan_rollback(tmp_path):
    """A NaN batch (the 6th) rolls back to the last checkpoint and is
    consumed; the run ends at step 8 after one rollback (the JAX package's
    test_runner_nan_rollback)."""
    def step_fn(params, opt, batch):
        loss = params["w"][0] + batch["x"][0]
        params["w"].sub_(0.1)             # in place, as the port's step
        return params, opt, {"loss": loss}

    it = _Ones()
    runner = tft.TrainingRunner(
        tft.RunnerConfig(ckpt_dir=str(tmp_path), ckpt_every=2,
                         max_rollbacks=3),
        step_fn, {"w": torch.ones(1)}, {"dummy": torch.zeros(())}, it)

    def poison(step, batch):
        return {"x": torch.full((2,), float("nan"))} if it.i == 6 else batch

    assert runner.run(8, poison_hook=poison) == "done"
    assert runner.rollbacks == 1 and runner.step == 8
    # steps 1-4, then 5 rolled back to 4's checkpoint and redone, 6-8
    np.testing.assert_allclose(runner.params["w"].numpy(), [1 - 0.8],
                               rtol=1e-6)


def test_runner_preemption(tmp_path):
    def step_fn(params, opt, batch):
        return params, opt, {"loss": torch.zeros(())}

    runner = tft.TrainingRunner(tft.RunnerConfig(ckpt_dir=str(tmp_path)),
                                step_fn, {"w": torch.ones(1)}, {}, _Ones())
    runner.run(3)
    runner.preempt()
    assert runner.run(10) == "preempted"
    r2 = tft.TrainingRunner(tft.RunnerConfig(ckpt_dir=str(tmp_path)),
                            step_fn, {"w": torch.zeros(1)}, {}, _Ones())
    assert r2.try_resume() and r2.step == 3
    assert float(r2.params["w"][0]) == 1.0


def _runner(tmp_path, cfg, steps, start=0):
    api, params, opt, step, data = ttrain.build_everything(
        cfg, None, 2, 16, seed=0, steps=20, device="cpu")
    data.close()
    data = TokenPipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=16,
                                    global_batch=2, seed=0),
                         start_step=start, device="cpu")
    return tft.TrainingRunner(tft.RunnerConfig(ckpt_dir=str(tmp_path),
                                               ckpt_every=2),
                              step, params, opt, data)


def test_runner_resume_is_bitwise(tmp_path):
    """The smoke model trained 4 steps straight, and 2 steps, preempted, a
    new runner resumed from the checkpoint (its pipeline at the saved
    step) for 2 more: the same params and optimizer state, bitwise."""
    from repro_torch.configs import get_smoke_config
    cfg = get_smoke_config("qwen2-7b")
    straight = _runner(tmp_path / "a", cfg, 4)
    straight.run(4)
    first = _runner(tmp_path / "b", cfg, 2)
    first.run(2)
    first.preempt()
    assert first.run(1) == "preempted"
    second = _runner(tmp_path / "b", cfg, 2, start=2)
    assert second.try_resume() and second.step == 2
    second.run(2)
    for a, b in zip(leaves({"p": straight.params, "o": straight.opt_state}),
                    leaves({"p": second.params, "o": second.opt_state})):
        assert torch.equal(a, b)
    for r in (straight, first, second):
        r.data.close()


def test_checkpoints_cross_packages(tmp_path):
    """{"params", "opt"} written by the JAX runner is restored by the
    port's, and the port's by the JAX runner, leaf for leaf (bf16 params
    and state, the smoke model in the config's own dtype)."""
    from repro.configs import get_smoke_config as jget
    from repro.models import build_model as jbuild
    from repro_torch.configs import get_smoke_config as tget
    cfg = jget("qwen2-7b")
    jp = jax.jit(jbuild(cfg).init)(jax.random.key(0))
    jo = jopt.init_opt_state(jp, jopt.OptimizerConfig(
        state_dtype="bfloat16"))
    jo = {"m": jax.tree.map(lambda p: (p * 0.5).astype(jnp.bfloat16), jp),
          "v": jax.tree.map(lambda p: (p * p).astype(jnp.bfloat16), jp),
          "step": jnp.asarray(7, jnp.int32)}
    jr = jft.TrainingRunner(jft.RunnerConfig(ckpt_dir=str(tmp_path / "j")),
                            None, jp, jo, None)
    jr.step = 7
    jr._checkpoint()
    jr.ckpt.wait()
    tcfg = tget("qwen2-7b")
    port = _runner(tmp_path / "j", tcfg.replace(parallel=dataclasses.replace(
        tcfg.parallel, opt_state_dtype="bfloat16")), 0)
    assert port.try_resume() and port.step == 7
    want = jax.tree.leaves(jax.device_get({"params": jp, "opt": jo}))
    got = leaves({"params": port.params, "opt": port.opt_state})
    for g, w in zip(got, want):
        assert np.array_equal(g.float().numpy(),
                              np.asarray(w).astype(np.float32))
    # and back: the port's checkpoint restored by the JAX runner
    for p in leaves(port.params):
        p.mul_(2)
    port.ckpt = AsyncCheckpointer(str(tmp_path / "t"))
    port.step = 9
    port._checkpoint()
    port.ckpt.wait()
    jr2 = jft.TrainingRunner(jft.RunnerConfig(ckpt_dir=str(tmp_path / "t")),
                             None, jp, jo, None)
    assert jr2.try_resume() and jr2.step == 9
    for g, w in zip(leaves(port.params), jax.tree.leaves(jr2.params)):
        assert np.array_equal(g.float().numpy(),
                              np.asarray(w).astype(np.float32))
    port.data.close()


def test_training_loss_decreases_end_to_end(tmp_path):
    """Tiny LM + synthetic Markov data: CE drops well below ln(V) (the data
    pipeline is learnable, the optimizer works, the runner checkpoints).
    The port's ``build_everything`` with the JAX test's own init carried
    into its params, as every test here hands both packages one set of
    weights: from it the port's 80 losses follow JAX's (a drop of 0.2007
    in both; the port's own seed-0 draw, other numbers of the same
    distribution, drops 0.144 in this short run)."""
    from repro.configs import get_smoke_config as jget
    from repro.models import build_model as jbuild
    from repro_torch import convert
    api, params, opt, step, data = ttrain.build_everything(
        get_smoke_config("qwen2-7b"), None, 8, 64, steps=80, device="cpu")
    jp = jax.jit(jbuild(jget("qwen2-7b")).init)(jax.random.key(0))
    shared = convert.lm_params_from_numpy(jax.device_get(jp), device="cpu")
    for p, q in zip(leaves(params), leaves(shared)):
        p.copy_(q)
    runner = tft.TrainingRunner(tft.RunnerConfig(ckpt_dir=str(tmp_path),
                                                 ckpt_every=100),
                                step, params, opt, data)
    runner.run(80)
    data.close()
    first = np.mean(runner.history[:5])
    last = np.mean(runner.history[-5:])
    assert last < first - 0.15, (first, last)


def test_train_driver_smoke_on_cpu(tmp_path, capsys):
    runner = ttrain.main(["--arch", "qwen2-7b", "--smoke", "--device", "cpu",
                          "--steps", "20", "--batch", "2", "--seq", "32",
                          "--ckpt", str(tmp_path)])
    out = capsys.readouterr().out
    assert "status=done steps=20" in out and runner.step == 20
    assert all(np.isfinite(runner.history))
    # item 14f: the same driver on a 2x1 mesh (two data ranks)
    runner = ttrain.main(["--arch", "qwen2-7b", "--smoke", "--device", "cpu",
                          "--steps", "4", "--batch", "2", "--seq", "32",
                          "--mesh", "2x1", "--ckpt", str(tmp_path / "mesh")])
    assert runner.step == 4 and all(np.isfinite(runner.history))
