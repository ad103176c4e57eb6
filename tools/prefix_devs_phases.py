#!/usr/bin/env python3
"""Where a step of the prefix_devs kernel spends its cycles, on one card.

    python3 tools/prefix_devs_phases.py

Builds an instrumented copy of ``src/repro_torch/kernels/csrc/prefix_devs.cu``
(thread 0 adds ``clock64()`` deltas per phase of the walk; the anchors
below must match the source, else the script stops), runs it on the
arguments of each dataset's real lock-step scan round (round 3, captured as
``chip_smoke.py`` does), checks its outputs against the kernel's own, and
prints the cycles per ok rank of each phase and per launch of the chunk
work.  Then one thread times dependent chains of float64 add, multiply,
divide and square root, a shared-memory pointer chase and float32 add
(cycles per operation), the latencies a step is built from.  Build output
goes to ``build/phases/``.  Exits non-zero without a card.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import fused_round as _fused  # noqa: E402

CSRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
OUT = ROOT / "build" / "phases"
# phase slots: name -> index into the cycle counters
PHASES = {"init": 0, "chunk_list": 1, "stage_issue": 2, "sums": 3,
          "trial_rho": 4, "reduce": 5, "commit": 6, "copy_wait": 7,
          "barrier": 8, "fill": 9}
STEPS = 10   # slot of the ok-rank count


def instrument(src: str) -> str:
    """The kernel source with a TICK after each phase."""
    def put(anchor, text, after=True):
        nonlocal src
        if src.count(anchor) != 1:
            raise SystemExit(f"anchor not found once in prefix_devs.cu: "
                             f"{anchor!r}")
        src = src.replace(anchor, anchor + text if after else text + anchor)
    ph = {k: f"TICK({v})\n" for k, v in PHASES.items()}
    src = src.replace('#include "rn.cuh"',
                      '#include "rn.cuh"\n__device__ long long g_phase[16];')
    put("  const int zlen = nyb + 2 * L + Wy;\n",
        "  long long P[16] = {0}, t0 = 0, t1 = 0;\n"
        "#define TICK(i) if (tid == 0) { t1 = clock64(); P[i] += t1 - t0;"
        " t0 = t1; }\n  if (tid == 0) t0 = clock64();\n")
    put("    dev_c = deviation(a, t);\n  }\n", "  " + ph["init"])
    put("    const int n = min(kChunk, K - base);\n", "    " + ph["fill"])
    put("    for (int i = 0; i < n_ok; ++i) {\n", "    " + ph["chunk_list"],
        after=False)
    put("    for (int i = 0; i < n_ok; ++i) {\n",
        f"      if (tid == 0) ++P[{STEPS}];\n")
    put("      T* zc = z + s + L;\n      T a[5];\n", "      " + ph["stage_issue"],
        after=False)
    put("      T t[5];\n      const T dev = deviation(a, t);\n",
        "      " + ph["sums"], after=False)
    put("                         p0w);\n", "    " + ph["trial_rho"])
    put("      T t[5];\n      const T dev = deviation(a, t);\n",
        "      " + ph["reduce"])
    put("      cp_wait();\n      block_sync<kWarp>();\n    }\n",
        "      " + ph["commit"], after=False)
    src = src.replace("      cp_wait();\n      block_sync<kWarp>();\n    }\n",
                      "      cp_wait();\n      " + ph["copy_wait"]
                      + "      block_sync<kWarp>();\n      " + ph["barrier"]
                      + "    }\n")
    put("    // every rank that is not ok", "    " + ph["fill"], after=False)
    put("      if (cn == cp) out[base + p] = cp == 0 ? devc_start : "
        "devc_after[cp - 1];\n    }\n  }\n",
        "  if (tid == 0) for (int i = 0; i < 16; ++i) g_phase[i] = P[i];\n")
    return src + ('\nextern "C" int phases_read(void* h) { return (int)'
                  'cudaMemcpyFromSymbol(h, g_phase, sizeof(long long) * 16);'
                  ' }\n')


LATENCY_CU = r"""
#include <cuda_runtime.h>
__global__ void probe(double* out, long long* t, const double* in, int n) {
  __shared__ int nxt[1024];
  for (int i = threadIdx.x; i < 1024; i += blockDim.x)
    nxt[i] = (i * 7 + 3) & 1023;
  __syncthreads();
  if (threadIdx.x) return;
  double a = in[0], b = in[1];
  float f = (float)in[2], g = (float)in[3];
  int k = 0;
  long long c[7];
  c[0] = clock64();
  for (int i = 0; i < n; ++i) a = __dadd_rn(a, b);
  c[1] = clock64();
  for (int i = 0; i < n; ++i) a = __dmul_rn(a, b);
  c[2] = clock64();
  for (int i = 0; i < n; ++i) a = __ddiv_rn(a, b);
  c[3] = clock64();
  for (int i = 0; i < n; ++i) a = __dsqrt_rn(a);
  c[4] = clock64();
  for (int i = 0; i < n; ++i) k = nxt[k];
  c[5] = clock64();
  for (int i = 0; i < n; ++i) f = __fadd_rn(f, g);
  c[6] = clock64();
  out[0] = a + k + f;
  for (int i = 0; i < 6; ++i) t[i] = c[i + 1] - c[i];
}
extern "C" int latency(void* out, void* t, const void* in, int n) {
  probe<<<1, 32>>>((double*)out, (long long*)t, (const double*)in, n);
  return (int)cudaDeviceSynchronize();
}
"""


def nvcc(src: Path, lib: Path) -> ctypes.CDLL:
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(CSRC),
                           "-o", str(lib), str(src)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise SystemExit(f"nvcc {src.name} failed:\n{proc.stdout}"
                         f"{proc.stderr}")
    return ctypes.CDLL(str(lib))


def main() -> int:
    if not torch.cuda.is_available():
        print("prefix_devs_phases: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    print(chip_smoke.nvidia_smi())
    OUT.mkdir(parents=True, exist_ok=True)
    _build.build_all()
    src = OUT / "prefix_devs_phases.cu"
    src.write_text(instrument((CSRC / "prefix_devs.cu").read_text()))
    lib = nvcc(src, OUT / "libprefix_devs_phases.so")
    fn = lib.prefix_devs_f64
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    lib.phases_read.argtypes = [ctypes.c_void_p]
    for name in chip_smoke.DATASETS:
        cap = chip_smoke.capture_round(dev, name)
        a = cap["args"]
        y, dyws, table = a[0], a[1], a[4]
        K, Wy = dyws.shape
        L, nyb = table.shape[1], y.shape[0]
        use_smem = _fused.prefix_devs_layout(Wy, nyb, L, 8)
        out = torch.empty(K, dtype=torch.float64, device=dev)
        scratch = torch.empty(1 if use_smem else nyb + 2 * L + Wy,
                              dtype=torch.float64, device=dev)
        rc = fn(*[t.data_ptr() for t in a], out.data_ptr(),
                scratch.data_ptr(), K, Wy, nyb, L, 0, 1, int(use_smem), 1,
                torch.cuda.current_stream(dev).cuda_stream)
        torch.cuda.synchronize()
        if rc != 0:
            raise SystemExit(f"instrumented launch: CUDA error {rc}")
        want = _fused.prefix_devs_cuda(*a, L=L, measure="mae", greedy=True)
        if not torch.equal(out, want):
            raise SystemExit(f"{name}: the instrumented kernel's outputs "
                             f"differ from the kernel's")
        h = (ctypes.c_longlong * 16)()
        lib.phases_read(h)
        steps = max(h[STEPS], 1)
        per_step = {k: round(h[v] / steps, 1) for k, v in PHASES.items()
                    if k not in ("init", "chunk_list", "fill")}
        print("phases " + json.dumps(dict(
            dataset=name, round=cap["round"], K=K, ok_ranks=h[STEPS], L=L,
            Wy=Wy, cycles_per_ok_rank=per_step,
            cycles_per_launch={k: h[PHASES[k]] for k in
                               ("init", "chunk_list", "fill")})))
    (OUT / "latency.cu").write_text(LATENCY_CU)
    lat = nvcc(OUT / "latency.cu", OUT / "liblatency.so")
    lat.latency.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int]
    n = 1024
    res = torch.zeros(1, dtype=torch.float64, device=dev)
    t = torch.zeros(6, dtype=torch.int64, device=dev)
    inp = torch.tensor([1.5, 1.0000001, 1.25, 1.0], dtype=torch.float64,
                       device=dev)
    for _ in range(2):
        if lat.latency(res.data_ptr(), t.data_ptr(), inp.data_ptr(), n):
            raise SystemExit("latency probe failed")
    names = ("f64_add", "f64_mul", "f64_div", "f64_sqrt", "shared_load",
             "f32_add")
    print("latency_cycles " + json.dumps(
        {k: v / n for k, v in zip(names, t.tolist())}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
