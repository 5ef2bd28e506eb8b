"""Checkpointing: atomic, keep-k, async and verified, in the JAX package's
on-disk layout (``repro/checkpoint/manager.py``), so that a checkpoint
written by either package restores into the other.

Layout:  <dir>/step_<n>/
           manifest.json    step, metadata, and per leaf its file, shape,
                            dtype and crc32
           leaf_00000.npy   one file per leaf (the full logical array),
           ...              numbered in flatten order

Writes go to ``step_<n>.tmp`` and are renamed at the end, so a crash in the
middle of a write never damages the latest checkpoint. Every leaf's crc32 is
checked on load; a mismatch, a missing or truncated file, or an unreadable
manifest raises ``CorruptCheckpointError``, so a runner can fall back to the
step before instead of loading garbage. ``AsyncCheckpointer`` copies the
leaves to the host inline and writes them in a thread.

Keys and order (``_flatten``) are those ``jax.tree_util`` gives the JAX
package's state: a NamedTuple by its fields in order (key ``.field``), a
dict by its sorted keys, a dataclass (the metrics tree, which the JAX package
registers with dict keys) by its fields in order (key ``field``), a list or
tuple by index; ``None`` is no leaf. So the port's ``BrainState`` gives
``.neurons/.v``, ..., ``.chunk``, ``.stats/counters/<name>``, ... in the JAX
package's file order.

Leaves are torch tensors, numpy arrays, Python ints (the port's host
chunk counter: written as an int32 of shape (), read back as an int) or a
mesh's ``Sharded`` leaves (``parallel/sharding.py``: written whole, and
restored whole into their structure for the caller to place). numpy
has no bfloat16 of its own: a bf16 tensor is written as 2-byte void elements
with the manifest dtype ``bfloat16`` (what numpy writes for the JAX
package's ``ml_dtypes`` arrays) and read back as its uint16 bits, viewed as
``torch.bfloat16`` where the target leaf is a tensor.
"""
from __future__ import annotations

import dataclasses
import json
import os
import re
import shutil
import threading
import zlib
from typing import List, Optional

import numpy as np
import torch

from repro_torch.parallel.sharding import Sharded


class CorruptCheckpointError(RuntimeError):
    """A checkpoint failed verification: checksum mismatch, missing or
    truncated leaf file, or unreadable manifest. Distinct from structure
    mismatches (KeyError/ValueError), which mean the checkpoint is valid
    but does not fit the requested target tree."""


# ------------------------------------------------------------ tree walking
def _children(tree):
    """(key, child) pairs of a node, or None for a leaf."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [(f".{f}", getattr(tree, f)) for f in tree._fields]
    if isinstance(tree, dict):
        return [(str(k), tree[k]) for k in sorted(tree)]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [(f.name, getattr(tree, f.name))
                for f in dataclasses.fields(tree)]
    if isinstance(tree, (list, tuple)):
        return [(str(i), x) for i, x in enumerate(tree)]
    return None


def _flatten(tree, prefix: str = "") -> list:
    """[(key, leaf)] in the JAX package's flatten order."""
    kids = _children(tree)
    if kids is None:
        return [(prefix, tree)]
    out = []
    for key, child in kids:
        if child is not None:
            out.extend(_flatten(child, f"{prefix}/{key}" if prefix else key))
    return out


def _unflatten(tree, leaves):
    """``tree`` with its leaves replaced, in ``_flatten`` order, by
    ``leaves``."""
    it = iter(leaves)

    def build(node):
        if node is None:
            return None
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            return type(node)(*(build(getattr(node, f))
                                for f in node._fields))
        if isinstance(node, dict):
            built = {k: build(node[k]) for k in sorted(node)}
            return {k: built[k] for k in node}
        if dataclasses.is_dataclass(node) and not isinstance(node, type):
            return dataclasses.replace(node, **{
                f.name: build(getattr(node, f.name))
                for f in dataclasses.fields(node)})
        if isinstance(node, (list, tuple)):
            return type(node)(build(x) for x in node)
        return next(it)

    return build(tree)


def map_leaves(fn, tree):
    """``tree`` with every leaf replaced by ``fn(key, leaf)``."""
    return _unflatten(tree, [fn(k, x) for k, x in _flatten(tree)])


# ------------------------------------------------------------ leaves
def _dtype_name(leaf) -> str:
    if isinstance(leaf, (torch.Tensor, Sharded)):
        return str(leaf.dtype).replace("torch.", "")
    if isinstance(leaf, int):
        return "int32"
    return str(np.asarray(leaf).dtype)


def _to_numpy(leaf) -> np.ndarray:
    """A host leaf as the array written to disk (a mesh's ``Sharded`` leaf
    as the whole array)."""
    if isinstance(leaf, Sharded):
        leaf = leaf.full()
    if isinstance(leaf, torch.Tensor):
        x = leaf.detach().cpu()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.dtype("V2"))
        return x.numpy()
    if isinstance(leaf, int):
        return np.asarray(leaf, np.int32)
    return np.asarray(leaf)


def host_copy(tree):
    """A copy of ``tree`` that the caller owns, on the host: CUDA tensors
    copied into pinned memory (all queued, then one wait for each device),
    CPU tensors and numpy arrays copied, ints as they are. The copy of a
    CPU tensor is a real one: ``Tensor.cpu()`` would return the same
    storage, which the simulator's metrics update in place."""
    devices = set()

    def copy(_, x):
        if isinstance(x, Sharded):          # a mesh's leaf: the whole array
            x = x.full()
        if isinstance(x, torch.Tensor):
            if x.is_cuda:
                devices.add(x.device)
                return x.detach().to("cpu", non_blocking=True)
            return x.detach().clone()
        if isinstance(x, np.ndarray):
            return x.copy()
        return x

    out = map_leaves(copy, tree)
    for dev in devices:
        torch.cuda.synchronize(dev)
    return out


def _crc(arr: np.ndarray) -> int:
    """The crc32 of the array's bytes in C order (the JAX package's), read
    through the buffer: no copy of the bytes."""
    return zlib.crc32(np.ascontiguousarray(arr))


# ------------------------------------------------------------ save / load
def save(ckpt_dir: str, step: int, tree, metadata: Optional[dict] = None):
    """Synchronous atomic save of full logical arrays."""
    tmp = os.path.join(ckpt_dir, f"step_{step}.tmp")
    final = os.path.join(ckpt_dir, f"step_{step}")
    os.makedirs(tmp, exist_ok=True)
    leaves = _flatten(tree)
    if any(isinstance(x, torch.Tensor) and x.is_cuda for _, x in leaves):
        leaves = _flatten(host_copy(tree))   # one wait, not one a leaf
    manifest = {"step": step, "metadata": metadata or {}, "leaves": {}}
    for i, (key, leaf) in enumerate(leaves):
        arr = _to_numpy(leaf)
        fn = f"leaf_{i:05d}.npy"
        np.save(os.path.join(tmp, fn), arr)
        manifest["leaves"][key] = {"file": fn, "shape": list(arr.shape),
                                   "dtype": _dtype_name(leaf),
                                   "crc32": _crc(arr)}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def steps_available(ckpt_dir: str) -> List[int]:
    """All finalized checkpoint steps under ``ckpt_dir``, ascending."""
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(int(m.group(1)) for d in os.listdir(ckpt_dir)
                  if (m := re.fullmatch(r"step_(\d+)", d)))


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = steps_available(ckpt_dir)
    return steps[-1] if steps else None


def read_manifest(ckpt_dir: str, step: int) -> dict:
    """Load and minimally validate a step's manifest.
    Raises CorruptCheckpointError if missing or unparseable."""
    path = os.path.join(ckpt_dir, f"step_{step}", "manifest.json")
    try:
        with open(path) as f:
            manifest = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        raise CorruptCheckpointError(
            f"unreadable manifest for step {step}: {e}") from e
    if "leaves" not in manifest:
        raise CorruptCheckpointError(
            f"manifest for step {step} has no leaves table")
    return manifest


def load_arrays(ckpt_dir: str, step: int):
    """Every leaf of a checkpoint as a host array, checksums verified:
    ``({key: np.ndarray}, manifest)`` (a bf16 leaf as its uint16 bits).
    The elastic restore derives the ranks' rows of a new rank count from
    these global arrays without a target tree."""
    path = os.path.join(ckpt_dir, f"step_{step}")
    manifest = read_manifest(ckpt_dir, step)
    arrays = {}
    for key, info in manifest["leaves"].items():
        arrays[key] = _load_leaf(path, key, info, step)
    return arrays, manifest


def _load_leaf(path: str, key: str, info: dict, step: int) -> np.ndarray:
    try:
        arr = np.load(os.path.join(path, info["file"]))
    except (OSError, ValueError) as e:
        raise CorruptCheckpointError(
            f"step {step} leaf {key!r}: unreadable ({e})") from e
    crc = info.get("crc32")
    if crc is not None and _crc(arr) != crc:
        raise CorruptCheckpointError(
            f"step {step} leaf {key!r}: crc32 mismatch")
    if arr.dtype.kind == "V":  # numpy writes bf16 as 2-byte void elements
        if info.get("dtype") != "bfloat16" or arr.dtype.itemsize != 2:
            raise ValueError(f"step {step} leaf {key!r}: unsupported dtype "
                             f"{info.get('dtype')!r}")
        arr = arr.view(np.uint16)
    return arr


def as_leaf(arr: np.ndarray, target, dtype: str):
    """A loaded array in the kind of ``target``: a CPU tensor for a tensor
    (bf16 bits viewed as ``torch.bfloat16``), an int for an int, else the
    array."""
    if isinstance(target, (torch.Tensor, Sharded)):
        t = torch.from_numpy(arr)
        return t.view(torch.bfloat16) if dtype == "bfloat16" else t
    if isinstance(target, int):
        return int(arr)
    return arr


def restore(ckpt_dir: str, step: int, target_tree):
    """Restore into the structure of ``target_tree``, on the host: each
    leaf in the kind of the target's (a tensor target, on any device,
    including ``meta``, gives a CPU tensor; the caller places it). Every
    leaf's crc32 is verified (CorruptCheckpointError); a missing key
    raises KeyError, a shape or dtype other than the target's ValueError.
    Returns ``(tree, manifest)``."""
    path = os.path.join(ckpt_dir, f"step_{step}")
    manifest = read_manifest(ckpt_dir, step)
    out = []
    for key, leaf in _flatten(target_tree):
        info = manifest["leaves"].get(key)
        if info is None:
            raise KeyError(f"checkpoint missing leaf {key!r}")
        arr = _load_leaf(path, key, info, step)
        shape = () if isinstance(leaf, int) else tuple(leaf.shape)
        if tuple(arr.shape) != shape:
            raise ValueError(f"{key}: shape {arr.shape} != {shape}")
        if info["dtype"] != _dtype_name(leaf):
            raise ValueError(f"{key}: dtype {info['dtype']} != "
                             f"{_dtype_name(leaf)}")
        out.append(as_leaf(arr, leaf, info["dtype"]))
    return _unflatten(target_tree, out), manifest


def gc_old(ckpt_dir: str, keep: int):
    steps = steps_available(ckpt_dir)
    for s in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s}"), ignore_errors=True)


class AsyncCheckpointer:
    """Overlap disk writes with the simulation; the device -> host copy
    happens inline (``host_copy``), the write and the keep-k clean-up in a
    thread. An error of the writer is raised by the next ``wait``."""

    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.dir = ckpt_dir
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        os.makedirs(ckpt_dir, exist_ok=True)

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def save(self, step: int, tree, metadata=None):
        self.wait()
        host_tree = host_copy(tree)

        def work():
            try:
                save(self.dir, step, host_tree, metadata)
                gc_old(self.dir, self.keep)
            except Exception as e:   # noqa: BLE001 - raised again by wait
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def restore_latest(self, target_tree):
        """Restore the newest checkpoint that passes verification,
        walking past corrupt steps (newest first)."""
        self.wait()
        for step in reversed(steps_available(self.dir)):
            try:
                tree, manifest = restore(self.dir, step, target_tree)
            except CorruptCheckpointError:
                continue
            return step, tree, manifest
        return None, None, None
