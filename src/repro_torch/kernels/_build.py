"""Build and bind the port's CUDA kernels.

Every ``*.cu`` file under ``repro_torch/csrc/`` is compiled by ``nvcc`` for
``sm_90a`` (one process per source, all started together) and linked into one
shared library with a plain C interface, loaded with ``ctypes``. The library
goes to ``build/repro_torch_kernels/`` at the root of the checkout, named by
a hash of the sources and flags, so an edited source is rebuilt on first use.

Nothing here runs at import: the CPU tests import every module of the port on
a machine with no ``nvcc`` and no card. ``library()`` builds on first call.

Each C entry launches on the stream it is given (PyTorch's current stream),
allocates nothing, and returns ``cudaGetLastError()``; ``check`` raises when
that is not 0.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import time

import torch
from torch.utils._python_dispatch import TorchDispatchMode

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / \
    "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

P = ctypes.c_void_p
I = ctypes.c_int
U = ctypes.c_uint
F = ctypes.c_float

# C entry -> argument types (every pointer and the stream as c_void_p)
SIGNATURES = {
    "repro_threefry_draw": [P, P],      # DrawArgs struct, stream
    "repro_threefry_device_launches": [I],
    "repro_activity_window": (
        [P] * 7            # v, u, ca, ax, de, spike_count, spiked (inputs)
        + [P] * 7          # the same seven outputs
        + [P]              # spike bitmap scratch (2 x ceil(n / 32) words)
        + [P, P, P]        # in_edges, w_table, rates
        + [P, I]           # rate_slots (null: dense rates), subs_cap
        + [P, P]           # bg_mean, bg_std
        + [P] * 6          # izh a, b, c, d, nu, eps
        + [P, P, P, I]     # stimulus masks, amplitudes, windows, count
        + [P, P, I]        # lesion masks, windows, count
        + [P]              # fired counts (num_steps,) int32
        + [I, I, I, I, U, I, I, F, F, P]),
    "repro_activity_window_device_launches": [I, I],
    "repro_bh_traverse": (
        [P] * 9            # counts, cents, members, npos, vac, x, start, gid,
                           # valid
        + [P, P]           # host arrays: level sizes (float), widths (int)
        + [P]              # packed nodes scratch (float4 a node)
        + [P, P, P]        # out tgt, ok, depth
        + [I, I, I, I, I, I, I, I, U, F, F, I, I, P]),
    "repro_morton_sort": [P] * 4 + [ctypes.c_longlong, I, I, I, I, P],
    "repro_morton_sort_device_launches": [I],
    "repro_retract": [P] * 5 + [I, I, U, U, P],
    "repro_edge_priority": [P] * 4 + [I, U, U, P],
    "repro_tree_assemble": [P] * 8 + [I, I, I, I, P],
    "repro_tree_assemble_device_launches": [I],
    "repro_synapse_apply": ([P] * 11 + [P, ctypes.c_longlong, I, I, I, I]
                            + [U, U, P]),
    "repro_synapse_apply_device_launches": [I],
    "repro_route_build": [P] * 5 + [ctypes.c_longlong, I, I, I, I, P],
    "repro_route_build_device_launches": [I],
    "repro_neuron_step": [P, P],        # NeuronStepArgs struct, stream
    "repro_neuron_step_floor": [P, P],
    "repro_radix_argsort": [P] * 4 + [ctypes.c_longlong, I, I, P],
    "repro_radix_argsort_device_launches": [I],
    "repro_bh_gauss": [P] * 6 + [I, I, I, F, P],
    "repro_flash_attention": [P] * 4 + [I] * 8 + [F, I, P],
    "repro_flash_attention_wgmma": [P] * 4 + [I] * 8 + [F, P],
    "repro_flash_attention_device_launches": [I, I],
}


class LaunchCounter:
    """Launches of one kernel wrapper: the wrapper adds one where it
    launches its kernel and nowhere else."""

    def __init__(self, name: str):
        self.name = name
        self.count = 0
        COUNTERS[name] = self

    def add(self, k: int = 1) -> None:
        self.count += k


COUNTERS: dict = {}


def launch_counts() -> dict:
    return {name: c.count for name, c in COUNTERS.items()}


def reset_launch_counts() -> None:
    for c in COUNTERS.values():
        c.count = 0


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return path


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    cu, cuh = _sources()
    for p in cu + cuh:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build(verbose: bool = False) -> pathlib.Path:
    """Compile every source (in parallel) and link the shared library, unless
    a library of the same sources is already built. Returns its path."""
    so = BUILD_DIR / f"librepro_torch_kernels-{_digest()}.so"
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    cu, _ = _sources()
    t0 = time.perf_counter()
    procs = []
    for src in cu:
        obj = BUILD_DIR / f"{src.stem}-{os.getpid()}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed, objs = [], []
    for src, obj, proc in procs:
        out, _ = proc.communicate()
        if verbose and out:
            print(f"[nvcc {src.name}]\n{out}", flush=True)
        if proc.returncode != 0:
            failed.append(f"{src.name}:\n{out}")
        objs.append(str(obj))
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    link = subprocess.run([nvcc, "-shared", *NVCC_FLAGS[:2], *objs, "-o",
                           str(tmp)], capture_output=True, text=True)
    if link.returncode != 0:
        raise RuntimeError("nvcc link failed:\n" + link.stdout + link.stderr)
    os.replace(tmp, so)
    for o in objs:
        os.remove(o)
    if verbose:
        print(f"built {so.name} in {time.perf_counter() - t0:.1f} s",
              flush=True)
    return so


_LIB = None


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use), argtypes declared."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.repro_radix_argsort_workspace.argtypes = [I, I]
        lib.repro_radix_argsort_workspace.restype = ctypes.c_longlong
        lib.repro_synapse_apply_workspace.argtypes = [I, I, I]
        lib.repro_synapse_apply_workspace.restype = ctypes.c_longlong
        for name in ("repro_morton_sort_workspace",
                     "repro_route_build_workspace"):
            getattr(lib, name).argtypes = [I, I]
            getattr(lib, name).restype = ctypes.c_longlong
        lib.repro_error_string.argtypes = [ctypes.c_int]
        lib.repro_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def stream(device_index: int | None = None) -> int:
    """PyTorch's current CUDA stream on the device (the current device when
    None), as the int the C entries take. The raw handle, without the
    Stream object ``torch.cuda.current_stream()`` builds (a few us a
    call)."""
    if device_index is None:
        device_index = torch.cuda.current_device()
    return torch._C._cuda_getCurrentRawStream(device_index)


_SCRATCH: dict = {}


def scratch(device, stream_id: int, words: int):
    """An int32 tensor of at least ``words`` words on ``device``, kept for
    the next call on the same stream. The kernels that take it write every
    word before they read it, so its contents never matter, and calls on
    one stream run in order."""
    key = (device, stream_id)
    buf = _SCRATCH.get(key)
    if buf is None or buf.numel() < words:
        buf = torch.empty(max(words, 1), dtype=torch.int32, device=device)
        _SCRATCH[key] = buf
    return buf


def check(rc: int, name: str) -> None:
    if rc != 0:
        msg = library().repro_error_string(rc).decode()
        raise RuntimeError(f"CUDA kernel {name} failed to launch: {msg} "
                           f"(cudaError {rc})")


class FillCounter(TorchDispatchMode):
    """Inside its ``with`` block, the aten calls that fill memory with a
    constant (``zeros``, ``full``, ``fill_``, ...), by name in ``calls``:
    what a wrapper that fills a placeholder operand would launch."""

    NAMES = frozenset(("zeros", "zeros_like", "new_zeros", "ones",
                       "ones_like", "new_ones", "full", "full_like",
                       "new_full", "fill", "fill_", "zero_"))

    def __init__(self):
        super().__init__()
        self.calls = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.overloadpacket.__name__ in self.NAMES:
            self.calls.append(func.overloadpacket.__name__)
        return func(*args, **(kwargs or {}))


def as_dtype(x, dtype):
    """``x`` as a contiguous tensor of ``dtype``: itself when it is one
    (no copy, no launch)."""
    return x if x.dtype == dtype and x.is_contiguous() else \
        x.to(dtype).contiguous()


def require_cuda(name: str, *tensors) -> None:
    """Raise unless every tensor is a contiguous CUDA tensor."""
    for t in tensors:
        if t.device.type != "cuda":
            raise ValueError(f"{name}: every operand must be on the same CUDA "
                             f"device, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")
