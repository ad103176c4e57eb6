"""Build and bind the hand-written CUDA kernels.

Every ``csrc/*.cu`` source is compiled by ``nvcc`` into its own shared
library with a plain C interface, once per process at the first launch of
any kernel (all sources at once, one ``nvcc`` each, in parallel), into
``build/repro_torch/`` at the repository root.  The libraries are loaded
with ``ctypes``: pointers and the stream travel as ``c_void_p``, integers
as ``c_int``, and every entry point returns ``cudaGetLastError()``.
Nothing here runs at import.  ``csrc/launch_floor.cu`` is built with the
rest though no path launches it: an empty kernel that ``chip_smoke.py``
and the A/B tool time as the least a launch takes.

The builder is registered with ``repro_torch.obs`` as ``kernels.build``:
its ``_cache_size()`` counts the libraries built in this process, so the
recompile watermark's delta around a region counts ``nvcc`` builds in it.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

from repro_torch.obs import OBS

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC",
              # register / shared-memory / spill report, kept in the log
              "-Xptxas", "-v")


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                           "are built on the machine with the card")
    return found


class _Builder:
    """Compiles all sources on first use and caches the loaded libraries
    for the life of the process."""

    def __init__(self):
        self._lock = threading.Lock()
        self._libs = None
        self.seconds = None     # wall time of the one build
        self.logs = {}          # source stem -> nvcc/ptxas output
        self.built = 0          # libraries built in this process

    def _build(self):
        nvcc = _nvcc()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        jobs = {}
        for src in sorted(CSRC.glob("*.cu")):
            out = BUILD_DIR / f"lib{src.stem}.so"
            # unique temporary name, renamed into place: concurrent processes
            # never load a half-written library
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)]
            jobs[src.stem] = (out, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
        failed = []
        for stem, (out, tmp, proc) in jobs.items():
            log, _ = proc.communicate()
            self.logs[stem] = log
            if proc.returncode != 0:
                failed.append(f"{stem}.cu (exit {proc.returncode}):\n{log}")
            else:
                os.replace(tmp, out)
                self.built += 1
        self.seconds = time.perf_counter() - t0
        if failed:
            raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
        return {stem: ctypes.CDLL(str(out)) for stem, (out, _, _) in jobs.items()}

    def library(self, stem: str) -> ctypes.CDLL:
        with self._lock:
            if self._libs is None:
                self._libs = self._build()
            return self._libs[stem]

    def _cache_size(self) -> int:
        """Libraries built in this process (the recompile watermark's
        count for ``kernels.build``)."""
        return self.built


_BUILDER = _Builder()
OBS.register_jit("kernels.build", _BUILDER)


def build_all() -> dict:
    """Build every kernel now (a no-op after the first build in this
    process); returns ``{"seconds": ..., "logs": {stem: text}}``."""
    for src in sorted(CSRC.glob("*.cu")):
        _BUILDER.library(src.stem)
    return {"seconds": _BUILDER.seconds, "logs": dict(_BUILDER.logs)}


def library(stem: str) -> ctypes.CDLL:
    """The loaded ``lib<stem>.so`` (built on first use)."""
    return _BUILDER.library(stem)


def use_library(stem: str, lib: ctypes.CDLL) -> None:
    """Launch through ``lib`` in place of ``lib<stem>.so`` from now on in
    this process: tools that time another build of a kernel against this
    one swap the two through here."""
    _BUILDER.library(stem)
    with _BUILDER._lock:
        _BUILDER._libs[stem] = lib


def bind(stem: str, symbol: str, n_ptr: int, n_int: int):
    """The C entry point ``symbol`` of ``lib<stem>.so``, typed as
    ``n_ptr`` pointers, ``n_int`` ints and a trailing stream, returning
    the CUDA error code."""
    fn = getattr(_BUILDER.library(stem), symbol)
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def check(rc: int, what: str) -> None:
    """Raise when a launch returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")
