#!/usr/bin/env python3
"""Where a launch of the acf_impact kernel spends its cycles, on one card.

    python3 tools/acf_impact_phases.py [--tree DIR]

Builds an instrumented copy of ``src/repro_torch/kernels/csrc/acf_impact.cu``
(of this tree, or of the checkout DIR, for example the parent commit
unpacked with ``git archive``): every warp's lane 0 reads ``clock64()`` at
the phase boundaries below and adds the deltas to device counters, and
records its SM and its first and last clock, so the report has the mean
cycles a warp spends in each phase, the warps each SM ran and each SM's
span (first warp in to last warp out, in that SM's cycles).  A phase
boundary is a clock read, so a load's latency lands in the phase that
first uses the loaded value.  The text anchors of either kernel form (one
thread per candidate, and lanes placed by ``window.cuh``) must
match the source, else the script stops.

Runs on ``chip_smoke.py``'s phase-3 acf_impact cases (both datasets: the
rounds' float32 impacts and the sequential init's float64 ones), checks
the instrumented outputs against the kernel's own, and times both builds
with CUDA events.  Build output goes to ``build/phases/``.  Prints one JSON
line per case; exits non-zero without a card.
"""
from __future__ import annotations

import argparse
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
from repro_torch.kernels import acf_impact as _acf_impact  # noqa: E402

OUT = ROOT / "build" / "phases"
N_SM = 160   # counters per SM (the H100 has 132)

# The counters and the stamp macros, put after the includes.
PRELUDE = r"""
__device__ unsigned long long g_ph[160][8];
__device__ unsigned long long g_sm_first[160], g_sm_last[160],
    g_sm_warps[160];
#define PH_BEGIN                                                        \
  long long _c = clock64(), _t0 = _c, _ph[8] = {0, 0, 0, 0, 0, 0, 0, 0}; \
  unsigned _sm;                                                         \
  asm volatile("mov.u32 %0, %%smid;" : "=r"(_sm));
#define TICK(i)                                                         \
  {                                                                     \
    asm volatile("" ::: "memory");                                      \
    const long long _n = clock64();                                     \
    _ph[i] += _n - _c;                                                  \
    _c = _n;                                                            \
  }
#define PH_END                                                          \
  if ((threadIdx.x & 31) == 0) {                                        \
    for (int _i = 0; _i < 8; ++_i)                                      \
      atomicAdd(&g_ph[_sm][_i], (unsigned long long)_ph[_i]);           \
    atomicAdd(&g_sm_warps[_sm], 1ull);                                  \
    atomicMin(&g_sm_first[_sm], (unsigned long long)_t0);               \
    atomicMax(&g_sm_last[_sm], (unsigned long long)_c);                 \
  }
"""

EPILOGUE = r"""
extern "C" int phases_reset(void) {
  static unsigned long long z[160 * 8] = {0}, big[160];
  for (int i = 0; i < 160; ++i) big[i] = ~0ull;
  cudaError_t e = cudaMemcpyToSymbol(g_ph, z, sizeof(g_ph));
  if (!e) e = cudaMemcpyToSymbol(g_sm_warps, z, sizeof(g_sm_warps));
  if (!e) e = cudaMemcpyToSymbol(g_sm_last, z, sizeof(g_sm_last));
  if (!e) e = cudaMemcpyToSymbol(g_sm_first, big, sizeof(g_sm_first));
  return (int)e;
}
// h: ph[160][8], sm_warps[160], sm_first[160], sm_last[160]
extern "C" int phases_read(void* h) {
  unsigned long long* o = (unsigned long long*)h;
  cudaError_t e = cudaMemcpyFromSymbol(o, g_ph, sizeof(g_ph));
  if (!e) e = cudaMemcpyFromSymbol(o + 1280, g_sm_warps, sizeof(g_sm_warps));
  if (!e) e = cudaMemcpyFromSymbol(o + 1440, g_sm_first, sizeof(g_sm_first));
  if (!e) e = cudaMemcpyFromSymbol(o + 1600, g_sm_last, sizeof(g_sm_last));
  return (int)e;
}
"""

# (phase names, [(anchor, text, after)]) for each kernel form.
FORMS = {
    # one thread per candidate: the block stages the [6, L] table
    # behind a barrier, each thread chains its candidate's L lags
    "thread": (
        ("staging", "loads", "lag_loop", "store"),
        [("  extern __shared__ unsigned char sm_raw[];\n", "  PH_BEGIN\n",
          True),
         ("  __syncthreads();\n  const int p = blockIdx.x * blockDim.x + "
          "threadIdx.x;\n", "  TICK(0)\n", True),
         ("  T acc = 0;\n", "  TICK(1)\n", False),
         ("  out[p] = rn::measure_final(measure, acc, L);\n", "  TICK(2)\n",
          False),
         ("  out[p] = rn::measure_final(measure, acc, L);\n",
          "  TICK(3)\n  PH_END\n", True)]),
    # lanes placed by window.cuh: a block stages its table and y
    # values, a lane forms its lags' terms into shared memory, and after a
    # barrier thread c reduces candidate c's terms in lag order
    "lanes": (
        ("placement", "staging", "barrier", "lag_terms", "reduce", "store"),
        [("  const win::Slot sl = win::slot(lanes, G, cpu, M);\n",
          "  PH_BEGIN\n", False),
         ("  // -- staging\n", "  TICK(0)\n", False),
         ("  // -- barrier\n", "  TICK(1)\n", False),
         ("    // -- lag terms\n", "    TICK(2)\n", False),
         ("  // -- reduce\n", "  TICK(3)\n", False),
         ("  // -- store\n", "  TICK(4)\n", False),
         ("  // -- end\n", "  TICK(5)\n  PH_END\n", False)]),
}


def instrument(src: str):
    """The kernel source with the stamps of whichever form it has, and the
    form's phase names."""
    for form, (names, anchors) in FORMS.items():
        if all(src.count(a) == 1 for a, _, _ in anchors):
            break
    else:
        raise SystemExit("acf_impact.cu matches neither kernel form's "
                         "anchors; move them")
    for anchor, text, after in anchors:
        i = src.index(anchor)
        j = i + len(anchor) if after else i
        src = src[:j] + text + src[j:]
    src = src.replace('#include "rn.cuh"', '#include "rn.cuh"\n' + PRELUDE, 1)
    return src + EPILOGUE, form, names


def sm_clock_mhz():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else None


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", type=Path, default=ROOT,
                    help="the checkout whose acf_impact.cu is instrumented")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("acf_impact_phases: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    print(chip_smoke.nvidia_smi())
    OUT.mkdir(parents=True, exist_ok=True)
    for line in _build.build_all()["logs"]["acf_impact"].splitlines():
        if "registers" in line or "spill" in line:
            print("ptxas acf_impact: " + line.strip())
    csrc = args.tree.resolve() / "src" / "repro_torch" / "kernels" / "csrc"
    text, form, names = instrument((csrc / "acf_impact.cu").read_text())
    src = OUT / "acf_impact_phases.cu"
    src.write_text(text)
    for stem, path in (("plain", csrc / "acf_impact.cu"), ("phases", src)):
        lib = OUT / f"libacf_impact_{stem}.so"
        proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I",
                               str(csrc), "-o", str(lib), str(path)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise SystemExit(f"nvcc {path.name} failed:\n{proc.stdout}"
                             f"{proc.stderr}")
        if stem == "plain":
            built = ctypes.CDLL(str(lib))
        else:
            inst = ctypes.CDLL(str(lib))
    inst.phases_reset.argtypes = []
    inst.phases_read.argtypes = [ctypes.c_void_p]
    print("sm_clock_mhz (now, max) " + json.dumps(sm_clock_mhz()))
    for name in chip_smoke.DATASETS:
        for c in chip_smoke.acf_impact_cases(dev, name):
            kw = dict(c["kw"], measure="mae")
            _build.use_library("acf_impact", built)
            want = _acf_impact.acf_impact_cuda(*c["args"], **kw)
            ms_plain = chip_smoke.device_ms(
                lambda: _acf_impact.acf_impact_cuda(*c["args"], **kw), dev)
            _build.use_library("acf_impact", inst)
            got = _acf_impact.acf_impact_cuda(*c["args"], **kw)
            ms_inst = chip_smoke.device_ms(
                lambda: _acf_impact.acf_impact_cuda(*c["args"], **kw), dev)
            if not torch.equal(got, want):
                raise SystemExit(f"{name} {c['label']}: the instrumented "
                                 f"kernel's outputs differ from the kernel's")
            if inst.phases_reset():
                raise SystemExit("phases_reset failed")
            _acf_impact.acf_impact_cuda(*c["args"], **kw)
            torch.cuda.synchronize()
            h = (ctypes.c_ulonglong * 1760)()
            if inst.phases_read(h):
                raise SystemExit("phases_read failed")
            per_sm = [h[1280 + i] for i in range(N_SM)]
            warps = max(sum(per_sm), 1)
            used = [i for i in range(N_SM) if per_sm[i]]
            spans = [h[1600 + i] - h[1440 + i] for i in used]
            ph = [sum(h[8 * i + k] for i in range(N_SM)) for k in range(8)]
            print("phases " + json.dumps(dict(
                dataset=name, case=c["label"], shape=c["shape"], form=form,
                tree=str(args.tree), ms=ms_plain, ms_instrumented=ms_inst,
                warps=warps, sms_used=len(used),
                warps_per_sm_max=max(per_sm), warps_per_sm_min=min(
                    per_sm[i] for i in used),
                cycles_per_warp={k: round(ph[i] / warps, 1)
                                 for i, k in enumerate(names)},
                sm_span_cycles_max=max(spans),
                sm_span_cycles_mean=round(sum(spans) / len(spans), 1))),
                flush=True)
    _build.use_library("acf_impact", built)
    return 0


if __name__ == "__main__":
    sys.exit(main())
