"""Chaos hooks: faults injected on purpose to test recovery. The port's copy
of the runner's and the assimilation loop's hooks of the JAX package's
``repro/runtime/chaos.py``.

Runner hooks attach to ``SimulationRunner.chaos_hooks`` and fire after
every completed segment, before the runner's health poll and checkpoint,
the window a real fault would occupy. Each fires a bounded number of times
from a deterministic trigger (a chunk threshold), so recovery tests repeat
exactly:

  * ``poison_nan_once``     one element of a state field set to NaN
                            (state corruption -> rollback);
  * ``preempt_after``       the runner's preemption flag raised
                            (SIGTERM drain -> final checkpoint + exit);
  * ``corrupt_checkpoint``  a truncated, bit-flipped or cut manifest of an
                            on-disk checkpoint (the crc32 path: restores
                            must skip to an older step);
  * ``overflow_config``     not a hook: a config whose exchange caps
                            overflow every chunk, the pressure behind the
                            runner's degradation ladder;
  * ``drop_region_input``   one region's external drive zeroed for k
                            chunks (the assimilation loop's hook).
"""
from __future__ import annotations

import dataclasses
import os
from typing import Optional


def poison_nan_once(field: str = "v", index: int = 0,
                    after_chunk: int = 0):
    """Hook: once the state reaches ``after_chunk``, set one element of
    ``state.neurons.<field>`` (or ``positions``) to NaN, exactly once
    (``index`` into the global view; under a process group into this
    process's rank). The runner's pre-checkpoint probe (or the next chunk's
    verdict) must flag HEALTH_NONFINITE and roll back."""
    fired = {"done": False}

    def hook(runner):
        sim = runner.sim
        if fired["done"] or sim.chunk < after_chunk:
            return
        fired["done"] = True
        st = sim.state
        pos = field == "positions"
        leaf = (st.positions if pos else getattr(st.neurons, field)).clone()
        leaf.view(-1)[index] = float("nan")
        sim.state = st._replace(positions=leaf) if pos else st._replace(
            neurons=st.neurons._replace(**{field: leaf}))

    return hook


def preempt_after(chunk: int):
    """Hook: raise the preemption flag once the state reaches ``chunk``;
    the runner drains (a final checkpoint) and returns "preempted"."""
    def hook(runner):
        if runner.sim.chunk >= chunk:
            runner.preempt()

    return hook


def corrupt_checkpoint(ckpt_dir: str, step: Optional[int] = None,
                       mode: str = "flip"):
    """Damage the on-disk checkpoint at ``step`` (default: newest).
    ``mode``: 'flip' xors a byte in the middle of the first leaf file,
    'truncate' halves it, 'manifest' truncates manifest.json. Every mode
    must surface as ``CorruptCheckpointError`` on restore."""
    from repro_torch.checkpoint import manager
    if step is None:
        step = manager.latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
    path = os.path.join(ckpt_dir, f"step_{step}")
    if mode == "manifest":
        mpath = os.path.join(path, "manifest.json")
        with open(mpath, "r+b") as f:
            f.truncate(max(os.path.getsize(mpath) // 2, 1))
        return step
    leaf = sorted(f for f in os.listdir(path) if f.endswith(".npy"))[0]
    lpath = os.path.join(path, leaf)
    if mode == "truncate":
        with open(lpath, "r+b") as f:
            f.truncate(max(os.path.getsize(lpath) // 2, 1))
    elif mode == "flip":
        with open(lpath, "r+b") as f:
            f.seek(os.path.getsize(lpath) // 2 + 64)
            b = f.read(1)
            f.seek(-1, os.SEEK_CUR)
            f.write(bytes([b[0] ^ 0xFF]))
    else:
        raise ValueError(f"unknown mode {mode!r}")
    return step


def overflow_config(cfg, subs_cap_factor: float = 0.0001,
                    requests_cap_factor: Optional[float] = None):
    """A copy of ``cfg`` with the sparse exchange's subscription cap (and
    optionally the request routing cap) shrunk to the floor, so the
    registry overflows every chunk: the pressure source for the runner's
    degradation ladder."""
    kw = {"subs_cap_factor": subs_cap_factor}
    if requests_cap_factor is not None:
        kw["requests_cap_factor"] = requests_cap_factor
    return dataclasses.replace(cfg, **kw)


def drop_region_input(region, chunks: int = 2, after_chunk: int = 0):
    """Assimilation-loop hook: once the loop reaches ``after_chunk``, zero
    ``region``'s external background drive for ``chunks`` chunks, exactly
    once (``workloads.assimilate.AssimilationLoop.drop``). The controller
    must see the rate collapse and wind the drive back up after the drop
    window closes."""
    fired = {"done": False}

    def hook(loop):
        if fired["done"] or loop.chunk_index < after_chunk:
            return
        fired["done"] = True
        loop.drop(region, chunks)

    return hook
