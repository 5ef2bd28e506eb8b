#!/usr/bin/env python3
"""Count one Threefry-2x32's instructions in the code nvcc makes for the H100.

    python3 tools/k0_sass.py

Compiles two probe kernels that include ``src/repro_torch/csrc/hash.cuh``
with the library's flags (``kernels/_build.py`` NVCC_FLAGS) to a cubin and
disassembles them (``cuobjdump -sass``): ``one`` loads a key and a counter,
hashes once and stores; ``two`` hashes the first hash's output again under
the same key. Their difference is one Threefry's instructions with the key
schedule shared, as ``chip_smoke.py``'s HASH_OPS counts it. Also counts the
instructions of each draw kernel of the built library
(``csrc/hash_words.cu``). Then compiles each source that includes
``hash.cuh`` (K0's draw kernel, K1, K2, retraction) twice, with
``rotl32`` as it is written (shifts and an or) and as the intrinsic
``__funnelshift_l(x, x, r)`` (a copy of ``csrc`` under
``build/k0_sass/funnelshift/``), and compares the SASS of every function
instruction by instruction. Prints one JSON line; the disassembly goes to
``build/k0_sass/k0_sass.txt``. Needs nvcc and cuobjdump (a machine with the
CUDA toolkit), no card.
"""
from __future__ import annotations

import collections
import json
import pathlib
import re
import shutil
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels import _build  # noqa: E402

PROBE = r"""
#include <stdint.h>
#include "hash.cuh"
extern "C" __global__ void probe_one(const uint4* __restrict__ in,
                                     uint2* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const uint4 w = in[i];
  uint32_t x0, x1;
  repro::threefry2x32(w.x, w.y, w.z, w.w, &x0, &x1);
  out[i] = make_uint2(x0, x1);
}
extern "C" __global__ void probe_two(const uint4* __restrict__ in,
                                     uint2* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const uint4 w = in[i];
  uint32_t x0, x1, y0, y1;
  repro::threefry2x32(w.x, w.y, w.z, w.w, &x0, &x1);
  repro::threefry2x32(w.x, w.y, x0, x1, &y0, &y1);
  out[i] = make_uint2(y0, y1);
}
"""

ROTL = "  return (x << r) | (x >> (32 - r));\n"
FUNNEL = ("#ifdef __CUDA_ARCH__\n  return __funnelshift_l(x, x, r);\n#else\n"
          + ROTL + "#endif\n")
INCLUDERS = ("hash_words.cu", "activity_window.cu", "bh_traverse.cu",
             "retract.cu")

INSN = re.compile(r"/\*[0-9a-f]{4}\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)")


def cuobjdump() -> str:
    """cuobjdump beside the nvcc the library is built with."""
    path = pathlib.Path(_build._nvcc()).parent / "cuobjdump"
    if not path.exists():
        raise SystemExit(f"k0_sass: {path} not found")
    return str(path)


def functions(sass: str) -> dict:
    """Function name -> list of opcodes (without the NOP padding and the
    closing self-branch)."""
    out, name = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            out[name] = []
            continue
        m = INSN.search(line)
        if m and name is not None:
            out[name].append(m.group(2))
    for ops in out.values():
        while ops and ops[-1] in ("NOP", "BRA"):
            ops.pop()
    return out


def instructions(sass: str) -> dict:
    """Function name -> its instructions' text (opcode and operands, the
    address and encoding stripped)."""
    out, name = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            out[name] = []
            continue
        m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(.*?)\s*;", line)
        if m and name is not None:
            out[name].append(m.group(1))
    return out


def rotate_forms(work: pathlib.Path, flags: list) -> dict:
    """Each source that includes hash.cuh compiled with rotl32 as written
    and as __funnelshift_l: per source, whether every function's SASS is
    the same, its instructions and its funnel shifts under each form."""
    alt = work / "funnelshift"
    shutil.rmtree(alt, ignore_errors=True)
    shutil.copytree(_build.CSRC, alt)
    header = (alt / "hash.cuh").read_text()
    if header.count(ROTL) != 1:
        raise SystemExit("k0_sass: rotl32's body is not the expected form")
    (alt / "hash.cuh").write_text(header.replace(ROTL, FUNNEL))
    procs = {}
    for src in INCLUDERS:
        for form, csrc in (("written", _build.CSRC), ("funnelshift", alt)):
            cubin = work / f"{src}.{form}.cubin"
            procs[src, form] = (cubin, subprocess.Popen(
                [_build._nvcc(), *flags, "-I", str(csrc), "-cubin",
                 str(csrc / src), "-o", str(cubin)],
                stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True))
    sass = {}
    for key, (cubin, proc) in procs.items():
        _, err = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"k0_sass: nvcc failed for {key}:\n{err}")
        sass[key] = instructions(subprocess.run(
            [cuobjdump(), "-sass", str(cubin)], capture_output=True,
            text=True, check=True).stdout)
    out = {}
    for src in INCLUDERS:
        a, b = sass[src, "written"], sass[src, "funnelshift"]
        out[src] = {
            "same_sass": a == b,
            "functions": len(a),
            "instructions": [sum(map(len, a.values())),
                             sum(map(len, b.values()))],
            "funnel_shifts": [sum(i.startswith("SHF.L.W") for f in x.values()
                                  for i in f) for x in (a, b)]}
    return out


def main() -> int:
    work = ROOT / "build" / "k0_sass"
    work.mkdir(parents=True, exist_ok=True)
    src = work / "probe.cu"
    src.write_text(PROBE)
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-Xcompiler", "-fPIC",
                                                       "-Xptxas", "-v")]
    cubin = work / "probe.cubin"
    subprocess.run([_build._nvcc(), *flags, "-I", str(_build.CSRC), "-cubin",
                    str(src), "-o", str(cubin)], check=True)
    sass = subprocess.run([cuobjdump(), "-sass", str(cubin)],
                          capture_output=True, text=True, check=True).stdout
    lib = _build.build()
    lib_sass = subprocess.run([cuobjdump(), "-sass", str(lib)],
                              capture_output=True, text=True,
                              check=True).stdout
    (work / "k0_sass.txt").write_text(sass + "\n\n" + "\n".join(
        block for block in lib_sass.split("\n\n") if "draw_kernel" in block))
    probe = functions(sass)
    one, two = probe["probe_one"], probe["probe_two"]
    diff = collections.Counter(two)
    diff.subtract(collections.Counter(one))
    draws = {name: len(ops) for name, ops in functions(lib_sass).items()
             if "draw_kernel" in name}
    print(json.dumps({
        "probe_one_instructions": len(one),
        "probe_two_instructions": len(two),
        "threefry_instructions": len(two) - len(one),
        "threefry_by_opcode": {k: v for k, v in sorted(diff.items()) if v},
        "probe_one_by_opcode": dict(sorted(collections.Counter(one).items())),
        "draw_kernel_instructions": draws,
        "rotate_written_vs_funnelshift": rotate_forms(work, flags)}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
