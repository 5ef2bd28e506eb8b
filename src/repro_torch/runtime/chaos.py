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

Slot hooks attack a single tenant of the multi-tenant service
(``SimulationService.chaos_hooks``, fired after each tick's step, before
the health read):

  * ``poison_slot_nan``       one element of ONE slot's lane set to NaN,
                              the fault-isolation attack (co-tenants must
                              stay bitwise their solo runs);
  * ``stall_slot``            one slot's credited progress frozen for N
                              ticks (the stall-watchdog attack);
  * ``overflow_slot_config``  not a hook: a request whose chunk budget is
                              past the admission cap (the typed-rejection
                              attack).
"""
from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np


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


def poison_slot_nan(slot: int, field: str = "v", index: int = 0,
                    after_chunk: int = 0):
    """Service hook: once slot ``slot``'s chunk counter reaches
    ``after_chunk``, set element ``index`` of that lane's global
    ``neurons.<field>`` (or ``positions``) to NaN, exactly once. It writes
    in place, into the rank state that holds that element; no other lane
    and no snapshot shares that tensor (``SlotBatch.place`` and ``extract``
    copy). The service must quarantine and roll back that slot while every
    co-tenant stays bitwise its solo run."""
    fired = {"done": False}

    def hook(service):
        if fired["done"]:
            return
        st = service.state
        if int(service.batch.chunks(st)[slot]) < after_chunk:
            return
        fired["done"] = True
        lane = st[slot]
        if lane is None:       # an empty slot: nothing runs there
            return
        leaves = [s.positions if field == "positions"
                  else getattr(s.neurons, field) for s in lane]
        rank, local = divmod(index, leaves[0].numel())
        leaf = leaves[rank]
        leaf[tuple(int(i) for i in np.unravel_index(
            local, tuple(leaf.shape)))] = float("nan")

    return hook


def stall_slot(slot: int, ticks: int = 4, after_tick: int = 0):
    """Service hook: once the service reaches ``after_tick``, freeze slot
    ``slot``'s credited progress for ``ticks`` ticks, exactly once. The
    stall watchdog must quarantine (and eventually evict) only that
    slot."""
    fired = {"done": False}

    def hook(service):
        if fired["done"] or service.tick_count < after_tick:
            return
        fired["done"] = True
        service.slots[slot].stall_ticks = ticks

    return hook


def overflow_slot_config(request, max_chunks_per_request: int):
    """A copy of ``request`` whose chunk budget exceeds the service's
    admission cap: submitting it must raise the typed
    ``IncompatibleRequest``, never enqueue (the single-tenant overflow
    attack on admission control)."""
    return dataclasses.replace(request,
                               chunks=max_chunks_per_request + 1)


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
