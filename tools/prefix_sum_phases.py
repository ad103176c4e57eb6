#!/usr/bin/env python3
"""Where a launch of the prefix_sum kernel spends its cycles, on one card.

    python3 tools/prefix_sum_phases.py

Builds an instrumented copy of ``src/repro_torch/kernels/csrc/prefix_sum.cu``
(thread 0 of the first block of the first row reads ``clock64()`` at each
phase boundary; the anchors below must match the source, else the script
stops), launches it on the main path's rows (uk_elec's pair and B = 16's 32
rows, n = 18,432; aus_elec's pair and B = 4's 8 rows, n = 5,120; one row
and a pair of one value), checks the outputs against the plain version on
the CPU and prints the cycles of each phase of that block, the median over
``REPS`` launches after a warm one.  Build output goes to
``build/phases/``.  Exits non-zero without a card.
"""
from __future__ import annotations

import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import prefix_sum as _prefix_sum  # noqa: E402

CSRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
OUT = ROOT / "build" / "phases"
# the phase that ends at each stamp after the first
PHASES = ("setup and exchange barrier arrive", "loads issued",
          "upsweep (last round)", "publish", "exchange barrier wait",
          "pushes", "exchange wait", "scan of the tile totals",
          "carries", "downsweep and store")
SHAPES = ((2, 18432), (32, 18432), (2, 5120), (8, 5120), (1, 18432), (2, 1))
REPS = 7


def instrument(src: str) -> str:
    """The kernel source with a STAMP at each phase boundary."""
    def put(anchor, before="", after=""):
        nonlocal src
        if src.count(anchor) != 1:
            raise SystemExit(f"anchor not found once in prefix_sum.cu: "
                             f"{anchor!r}")
        src = src.replace(anchor, before + anchor + after)
    src = src.replace(
        '#include "rn.cuh"',
        '#include "rn.cuh"\n__device__ long long g_stamp[16];\n'
        '#define STAMP(i) if (blockIdx.x == 0 && blockIdx.y == 0 && '
        'threadIdx.x == 0) g_stamp[i] = clock64();\n')
    put("  x += row * n;\n", before="  STAMP(0);\n")
    put("  T v[16];\n", before="  STAMP(1);\n")
    put("    upsweep(s, v, k + 1 < rounds);\n", before="    STAMP(2);\n",
        after="    STAMP(3);\n")
    put("  cl::cluster_wait();\n", before="  STAMP(4);\n",
        after="  STAMP(5);\n")
    put("  cl::bar_wait(bar);\n", before="  STAMP(6);\n",
        after="  STAMP(7);\n")
    put("  // the carries of tile t", before="  STAMP(8);\n")
    put("  // pass 2: the last round", before="  STAMP(9);\n")
    put("    downsweep(s, v, car + 3 * k, out, t, n);\n  }\n",
        after="  STAMP(10);\n")
    src = src.replace(
        'extern "C" {',
        'extern "C" {\nint read_stamps(long long* h) {\n  return (int)'
        'cudaMemcpyFromSymbol(h, g_stamp, sizeof(long long) * 16);\n}\n', 1)
    return src


def build() -> ctypes.CDLL:
    OUT.mkdir(parents=True, exist_ok=True)
    src = OUT / "prefix_sum_phases.cu"
    src.write_text(instrument((CSRC / "prefix_sum.cu").read_text()))
    lib = OUT / "libprefix_sum_phases.so"
    res = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(CSRC),
                          "-o", str(lib), str(src)], capture_output=True,
                         text=True)
    if res.returncode != 0:
        raise SystemExit(f"build failed:\n{res.stdout}{res.stderr}")
    return ctypes.CDLL(str(lib))


def main() -> int:
    if not torch.cuda.is_available():
        print("prefix_sum_phases: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    print(chip_smoke.nvidia_smi())
    lib = build()
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.prefix_sum_f64.argtypes = [vp, vp, i32, i32, i32, vp]
    lib.prefix_sum_f64.restype = i32
    lib.read_stamps.argtypes = [vp]
    stamps = (ctypes.c_longlong * 16)()
    stream = torch.cuda.current_stream(dev).cuda_stream
    for rows, n in SHAPES:
        rng = np.random.default_rng(n)
        x = torch.from_numpy(rng.standard_normal((rows, n))).to(dev)
        out = torch.empty_like(x)
        cluster = min(_prefix_sum._MAX_CLUSTER, -(-n // _prefix_sum._TILE))
        per = {p: [] for p in PHASES}
        for rep in range(REPS + 1):
            chip_smoke.require(lib.prefix_sum_f64(
                x.data_ptr(), out.data_ptr(), n, rows, cluster, stream) == 0,
                "prefix_sum_phases: launch failed")
            torch.cuda.synchronize()
            lib.read_stamps(ctypes.cast(stamps, vp))
            if rep:
                for i, p in enumerate(PHASES):
                    per[p].append(stamps[i + 1] - stamps[i])
        chip_smoke.require(torch.equal(
            out.cpu(), _prefix_sum.prefix_sum_plain(x.cpu())),
            f"prefix_sum_phases: [{rows}, {n}] differs from the plain version")
        row = {p: statistics.median(v) for p, v in per.items()}
        print("phases " + json.dumps(dict(
            rows=rows, n=n, cluster=cluster, cycles=row,
            total=sum(row.values()))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
