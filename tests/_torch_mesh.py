"""Shared helpers of the mesh tests (``tests/test_torch_mesh_*.py``): the
JAX reference runs in one subprocess a file with 8 host devices (the XLA
flag must be set before jax starts), its meshes from
``repro.launch.mesh.make_mesh`` (Auto axes), and writes its results to an
npz that the port's tests read. The port runs every rank in the test
process (``dist.LocalMesh``) on the same numpy inputs.

Tolerances, stated once: float32 results 2e-3 absolute and relative (the
LM tests' ``F32_TOL``), bf16 losses 2e-3; integer results (expert ids,
positions, drops, int8 payloads) bit-equal; the pod sync at Delta = 1 the
JAX package's own 2e-5 against the direct step.
"""
import os
import subprocess
import sys
import textwrap

import numpy as np

SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))
TESTS = os.path.abspath(os.path.dirname(__file__))
F32_TOL = 2e-3


def run_jax(code: str, out_path: str, devices: int = 8, timeout=300):
    """Run ``code`` (which saves its results with ``np.savez(OUT, ...)``)
    with ``devices`` host devices; returns the saved arrays."""
    return run_jax_side_by_side([(code, out_path)], devices, timeout)


def run_jax_side_by_side(jobs, devices: int = 8, timeout=300):
    """``run_jax`` of every (code, out_path) of ``jobs``, each in its own
    process and all at once; returns their saved arrays merged."""
    env = dict(os.environ)
    # LLVM's optimisation level 0 compiles the references' many small
    # programs faster; the programs and their operations are the same
    env["XLA_FLAGS"] = (f"--xla_force_host_platform_device_count={devices} "
                        f"--xla_backend_optimization_level=0")
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.pathsep.join([SRC, TESTS])
    procs = [subprocess.Popen(
        [sys.executable, "-c", f"OUT = {path!r}\n" + textwrap.dedent(code)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
        for code, path in jobs]
    out = {}
    try:
        for proc, (_, path) in zip(procs, jobs):
            stdout, stderr = proc.communicate(timeout=timeout)
            assert proc.returncode == 0, stdout[-3000:] + "\n" + \
                stderr[-6000:]
            with np.load(path) as f:
                out.update({k: f[k] for k in f.files})
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    return out


def flat_names(tree, path=()):
    """(name, leaf) of every leaf of nested dicts and lists, the JAX
    package's flatten order (dict keys sorted)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from flat_names(tree[k], path + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from flat_names(v, path + (str(i),))
    else:
        yield "/".join(path), tree
