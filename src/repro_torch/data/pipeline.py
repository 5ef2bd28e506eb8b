"""Deterministic synthetic token pipeline: seekable and double-buffered.

The port of the JAX package's ``repro/data/pipeline.py``. ``state = (seed,
step)`` makes the stream exactly resumable from a checkpoint: a sample's
tokens depend only on (seed, global step, global row index), so data order
survives restarts. ``_batch_for_step`` is the JAX module's numpy, copied
(the port imports nothing of the JAX package) and bit-equal to it.

The generator is a structured Zipf-ish Markov stream (not iid uniform) so
cross-entropy actually decreases during the example training runs.

On a CUDA device ``__next__`` copies each batch from a pinned host buffer
with a non-blocking copy: the host does not wait for the stream (a
``torch.as_tensor(x, device="cuda")`` would). Two pinned buffers take turns,
and a buffer is refilled only after the copy out of it has completed (an
event recorded behind the copy), so a batch is never overwritten while the
card still reads it. Sharding across processes (``num_shards``) takes every
``num_shards``-th row, as the JAX pipeline does. With ``sharding`` (the
batch's spec on a mesh, ``parallel.sharding.batch_sharding``) the rows are
block ``shard_index`` of ``num_shards``, the block the model itself would
slice from the whole batch, and the tokens carry the spec, so the model
takes them as that rank's rows. Either way a row's tokens depend only on
(seed, step, row), so the token stream does not change with the mesh.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Iterator

import numpy as np
import torch

from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    # Markov structure: tok_{t+1} = (a * tok_t + drift) % V with noise
    noise_p: float = 0.15


def _splitmix64(x: np.ndarray) -> np.ndarray:
    """Vectorized splitmix64: a stateless hash, so sample identity depends
    only on (seed, step, row, t)."""
    with np.errstate(over="ignore"):
        x = (x + np.uint64(0x9E3779B97F4A7C15)).astype(np.uint64)
        x = ((x ^ (x >> np.uint64(30)))
             * np.uint64(0xBF58476D1CE4E5B9)).astype(np.uint64)
        x = ((x ^ (x >> np.uint64(27)))
             * np.uint64(0x94D049BB133111EB)).astype(np.uint64)
        return x ^ (x >> np.uint64(31))


PATTERN_LEN = 8


def _batch_for_step(cfg: DataConfig, step: int, rows: np.ndarray):
    """Deterministic rows of the global batch (row identity is global).

    Each row repeats a per-(row, step) pattern of PATTERN_LEN tokens with
    noise_p corruption: learnable by induction (copy from t-8), so example
    training runs show real loss curves down to the noise floor."""
    v = cfg.vocab_size
    rows = rows.astype(np.uint64)
    base = (np.uint64(cfg.seed) * np.uint64(0x1000003)
            + np.uint64(step) * np.uint64(0x10001)).astype(np.uint64)
    pi = np.arange(PATTERN_LEN, dtype=np.uint64)
    pattern = _splitmix64(base[None] + rows[:, None] * np.uint64(7919)
                          + pi[None, :] * np.uint64(104_729)) % np.uint64(v)
    ts = np.arange(cfg.seq_len, dtype=np.uint64)
    h = _splitmix64(base[None] + rows[:, None] * np.uint64(65_537)
                    + ts[None, :] * np.uint64(257))
    noise = (h % np.uint64(10_000)) < np.uint64(int(cfg.noise_p * 10_000))
    rand = _splitmix64(h) % np.uint64(v)
    toks = pattern[:, (np.arange(cfg.seq_len) % PATTERN_LEN)]
    toks = np.where(noise, rand, toks)
    return toks.astype(np.int32)


class TokenPipeline:
    """Iterator of {'tokens': (B_local, S) int32 tensor on ``device``} with
    background prefetch (a producer thread computes the numpy batches)."""

    def __init__(self, cfg: DataConfig, shard_index: int = 0,
                 num_shards: int = 1, start_step: int = 0, prefetch: int = 2,
                 device=None, sharding=None):
        assert cfg.global_batch % num_shards == 0
        self.cfg = cfg
        rows = np.arange(cfg.global_batch)
        if sharding is not None:
            n = cfg.global_batch // num_shards
            self.rows = rows[shard_index * n:(shard_index + 1) * n]
        else:
            self.rows = rows[shard_index::num_shards] if num_shards > 1 \
                else rows
        self.sharding = sharding
        self.step = start_step
        self.device = resolve_device(device)
        self._staging = []
        if self.device.type == "cuda":
            shape = (len(self.rows), cfg.seq_len)
            self._staging = [[torch.empty(shape, dtype=torch.int32,
                                          pin_memory=True), None]
                             for _ in range(2)]
        self._turn = 0
        self._q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._producer, daemon=True)
        self._thread.start()

    def _producer(self):
        step = self.step
        while not self._stop.is_set():
            batch = _batch_for_step(self.cfg, step, self.rows)
            self._q.put((step, batch))
            step += 1

    def __iter__(self) -> Iterator[dict]:
        return self

    def __next__(self) -> dict:
        out = self._next()
        if self.sharding is not None:
            from repro_torch.parallel import sharding as shd
            shd.set_spec(out["tokens"], self.sharding)
        return out

    def _next(self) -> dict:
        step, batch = self._q.get()
        self.step = step + 1
        if self.device.type != "cuda":
            return {"tokens": torch.from_numpy(batch).to(self.device)}
        slot = self._staging[self._turn]
        self._turn ^= 1
        if slot[1] is not None:
            slot[1].synchronize()       # the copy out of it has completed
        slot[0].numpy()[...] = batch
        out = slot[0].to(self.device, non_blocking=True)
        slot[1] = torch.cuda.Event()
        slot[1].record()
        return {"tokens": out}

    def state(self) -> dict:
        return {"seed": self.cfg.seed, "step": self.step}

    def close(self):
        self._stop.set()
        try:
            self._q.get_nowait()
        except queue.Empty:
            pass
