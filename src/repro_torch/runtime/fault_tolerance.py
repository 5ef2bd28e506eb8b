"""Fault-tolerant training runner and the heartbeat file of a long run:
the port of the JAX package's ``repro/runtime/fault_tolerance.py``.

``TrainingRunner`` wraps a train step (``launch/steps.py``) with periodic
async checkpoints of ``{"params", "opt"}`` in the JAX package's layout
(``checkpoint.manager.AsyncCheckpointer``, keep-k, crc32 a leaf; either
package restores the other's), resume from the newest good checkpoint, NaN /
Inf rollback (the last checkpoint restored, the poisoned batch consumed, so
training continues past it), simulated preemption (a final checkpoint and a
clean exit) and a heartbeat file a step. The port's step updates the params
in place, so a restore copies the checkpoint into the live tensors. Reading
the step's loss on the host is its one wait a step, as in JAX. An external
watchdog reads the heartbeat and restarts a run whose beat has gone stale;
``runtime.sim_runner.SimulationRunner`` writes it too.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import time
from typing import Callable, Optional

import torch

from repro_torch.checkpoint.manager import AsyncCheckpointer


def write_heartbeat(path: str, payload: dict):
    """Atomically publish a heartbeat JSON (``payload`` + a ``t``
    timestamp): write a sibling temp file, then ``os.replace``, so readers
    see either the previous heartbeat or the new one, never a torn
    write."""
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(dict(payload, t=time.time()), f)
    os.replace(tmp, path)


def read_heartbeat(path: str, max_age_s: Optional[float] = None,
                   now: Optional[float] = None):
    """Watchdog-side read of an atomic heartbeat: returns
    ``(payload, age_s, verdict)`` with verdict one of ``'fresh'``,
    ``'stale'`` (age over ``max_age_s``), ``'missing'`` (no or garbled
    file: a torn write cannot happen, so unreadable JSON means the process
    never completed a heartbeat). ``now`` overrides the clock for tests."""
    try:
        with open(path) as f:
            payload = json.load(f)
        t = float(payload["t"])
    except (OSError, ValueError, KeyError, TypeError):
        return None, None, "missing"
    age = (time.time() if now is None else now) - t
    if max_age_s is not None and age > max_age_s:
        return payload, age, "stale"
    return payload, age, "fresh"


@dataclasses.dataclass
class RunnerConfig:
    ckpt_dir: str
    ckpt_every: int = 50
    keep: int = 3
    max_rollbacks: int = 3
    heartbeat_path: Optional[str] = None


def _copy_into(dst, src):
    """Copy a restored host tree into the live tree's tensors, in place."""
    if isinstance(dst, dict):
        for k in dst:
            _copy_into(dst[k], src[k])
    elif isinstance(dst, (list, tuple)):
        for d, s in zip(dst, src):
            _copy_into(d, s)
    else:
        with torch.no_grad():
            dst.copy_(src, non_blocking=True)


class TrainingRunner:
    """Wraps a step function with checkpoint/restart + NaN rollback."""

    def __init__(self, cfg: RunnerConfig, step_fn: Callable, params,
                 opt_state, data_iter):
        self.cfg = cfg
        self.step_fn = step_fn
        self.params = params
        self.opt_state = opt_state
        self.data = data_iter
        self.ckpt = AsyncCheckpointer(cfg.ckpt_dir, keep=cfg.keep)
        self.step = 0
        self.rollbacks = 0
        self.preempted = False
        self.history = []

    # ---- lifecycle -------------------------------------------------------
    def try_resume(self):
        tree = {"params": self.params, "opt": self.opt_state}
        step, restored, manifest = self.ckpt.restore_latest(tree)
        if step is not None:
            _copy_into(tree, restored)
            self.step = int(manifest["metadata"].get("next_step", step))
            return True
        return False

    def _checkpoint(self):
        self.ckpt.save(self.step,
                       {"params": self.params, "opt": self.opt_state},
                       metadata={"next_step": self.step})

    def _heartbeat(self):
        if self.cfg.heartbeat_path:
            write_heartbeat(self.cfg.heartbeat_path, {"step": self.step})

    def preempt(self):
        """External preemption signal (a SIGTERM handler calls this)."""
        self.preempted = True

    # ---- main loop -------------------------------------------------------
    def run(self, num_steps: int, poison_hook: Optional[Callable] = None):
        """poison_hook(step, batch) -> batch lets tests inject NaNs."""
        end = self.step + num_steps
        while self.step < end:
            if self.preempted:
                self._checkpoint()
                self.ckpt.wait()
                return "preempted"
            batch = next(self.data)
            if poison_hook is not None:
                batch = poison_hook(self.step, batch)
            params, opt_state, metrics = self.step_fn(
                self.params, self.opt_state, batch)
            loss = float(metrics["loss"])
            if not math.isfinite(loss):
                # rollback: restore the last good state; the poisoned batch
                # is consumed (skipped), so training continues past it
                self.rollbacks += 1
                if self.rollbacks > self.cfg.max_rollbacks:
                    raise RuntimeError("too many NaN rollbacks")
                self.ckpt.wait()
                if not self.try_resume():
                    raise RuntimeError("NaN before first checkpoint")
                continue
            self.params, self.opt_state = params, opt_state
            self.step += 1
            self.history.append(loss)
            self._heartbeat()
            if self.step % self.cfg.ckpt_every == 0:
                self._checkpoint()
        self._checkpoint()
        self.ckpt.wait()
        return "done"
