"""Control-stream scanners for the vectorized bitstream decoders.

The decode hot path in ``store/codec.py`` is two-phase: a *scan* walks the
control bits once to recover each record's branch case and payload
bit-offset (sequential by construction — Gorilla's meaningful-bit window
and Chimp's leading-zero bucket are carried state), then numpy gathers all
payload fields in bulk and closes the value chains with
``np.bitwise_xor.accumulate`` / ``np.cumsum``.  This module provides the
scan in two interchangeable forms:

* a **native scanner** — ~60 lines of dependency-free C99, compiled once
  with the system ``cc`` on first use (cached per source hash in the
  repository's git-ignored ``build/repro_torch``) and called through
  ``ctypes``.  A few ns per record; this is
  what makes store reads ~10-30x faster than the ``*_loop`` oracles.
* a **pure-Python fallback** — the same algorithm over precomputed 24-bit
  byte windows, used automatically when no C compiler is available (or
  when ``CAMEO_NATIVE_SCAN=0``).  Still several times faster than the
  loop decoders because it touches only control bits and consumes runs of
  zero-control records in bulk.

Both forms emit the identical packed ``int64`` record array (one entry per
*non-zero* record; zero-xor / repeated-delta records are implicit), so the
numpy post-processing in ``codec.py`` is oblivious to which scanner ran.
Parity of the two scanners is pinned by ``tests/test_store.py``.
"""
from __future__ import annotations

import atexit
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile

import numpy as np

_C_SOURCE = r"""
#include <stdint.h>

/* 24-bit big-endian window starting at byte b, masked to the low
   24 - (bit & 7) bits: bits [bit, bit + avail) of the stream.  The caller
   pads the buffer so the 3-byte read never runs past the end. */
static inline long win24(const uint8_t *d, long bp, long *avail) {
    long b = bp >> 3, r = bp & 7;
    long x = ((long)d[b] << 16) | ((long)d[b + 1] << 8) | (long)d[b + 2];
    *avail = 24 - r;
    return x & ((1L << *avail) - 1);
}

static inline long bitlen(long x) {
    return x ? 64 - __builtin_clzll((unsigned long long)x) : 0;
}

/* Gorilla value stream: out[k] = (i << 15) | (new_window << 14)
   | (sig << 7) | shift.  Returns the number of non-zero records. */
long gorilla_scan(const uint8_t *d, long m, int64_t *out) {
    long bp = 64, i = 0, k = 0, plz = -1, ptz = -1, avail;
    while (i < m) {
        long x = win24(d, bp, &avail);
        if (!(x >> (avail - 1))) {            /* '0' run: zero xors */
            long take = avail - bitlen(x);
            if (take > m - i) take = m - i;
            bp += take; i += take;
            continue;
        }
        long w = x >> (avail - 13), sig;
        if (w < 0x1800) {                     /* '10' reuse window */
            sig = 64 - plz - ptz;
            out[k++] = ((int64_t)i << 15) | (sig << 7) | ptz;
            bp += 2 + sig;
        } else {                              /* '11' new window */
            plz = (w >> 6) & 0x1F;
            sig = w & 0x3F; if (!sig) sig = 64;
            ptz = 64 - plz - sig;
            out[k++] = ((int64_t)i << 15) | 0x4000 | (sig << 7) | ptz;
            bp += 13 + sig;
        }
        i++;
    }
    return k;
}

/* Chimp value stream: out[k] = (i << 15) | (case << 13) | (width << 6)
   | shift.  Returns the number of non-zero records. */
long chimp_scan(const uint8_t *d, long m, int64_t *out) {
    static const long buckets[8] = {0, 8, 12, 16, 18, 20, 22, 24};
    long bp = 64, i = 0, k = 0, prev_lzb = -1, avail;
    while (i < m) {
        long x = win24(d, bp, &avail);
        if (!(x >> (avail - 2))) {            /* '00' run: zero xors */
            long take = (avail - bitlen(x)) >> 1;
            if (take > m - i) take = m - i;
            bp += 2 * take; i += take;
            prev_lzb = -1;
            continue;
        }
        long w = x >> (avail - 11), c = w >> 9;
        if (c == 1) {                         /* '01' center form */
            long lzb = buckets[(w >> 6) & 7];
            long center = w & 0x3F; if (!center) center = 64;
            out[k++] = ((int64_t)i << 15) | (1L << 13) | (center << 6)
                       | (64 - lzb - center);
            bp += 11 + center;
            prev_lzb = -1;
        } else if (c == 2) {                  /* '10' bucket reuse */
            long width = 64 - prev_lzb;
            out[k++] = ((int64_t)i << 15) | (2L << 13) | (width << 6);
            bp += 2 + width;
        } else {                              /* '11' new bucket */
            prev_lzb = buckets[(w >> 6) & 7];
            long width = 64 - prev_lzb;
            out[k++] = ((int64_t)i << 15) | (3L << 13) | (width << 6);
            bp += 5 + width;
        }
        i++;
    }
    return k;
}

/* Delta-of-delta index stream: out[k] = (i << 2) | bucket. */
long index_scan(const uint8_t *d, long m, int64_t *out) {
    long bp = 32, i = 0, k = 0, avail;
    while (i < m) {
        long x = win24(d, bp, &avail);
        if (!(x >> (avail - 1))) {            /* '0' run: repeated deltas */
            long take = avail - bitlen(x);
            if (take > m - i) take = m - i;
            bp += take; i += take;
            continue;
        }
        long w = x >> (avail - 4);
        if (w < 12)       { out[k++] = ((int64_t)i << 2);     bp += 2 + 7;  }
        else if (w < 14)  { out[k++] = ((int64_t)i << 2) | 1; bp += 3 + 9;  }
        else if (w == 14) { out[k++] = ((int64_t)i << 2) | 2; bp += 4 + 12; }
        else              { out[k++] = ((int64_t)i << 2) | 3; bp += 4 + 32; }
        i++;
    }
    return k;
}
"""


def _cache_dir() -> str:
    """Private (0700, caller-owned) build-cache dir: ``build/repro_torch``
    at the repository root (git-ignored), where the CUDA kernels are built
    too.

    Never a shared world-writable location: loading a ``.so`` from a
    predictable path in /tmp would let another local user pre-plant a
    malicious library.  Falls back to a fresh per-process mkdtemp when the
    directory is not the caller's own.
    """
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))), "build", "repro_torch")
    try:
        os.makedirs(path, mode=0o700, exist_ok=True)
        st = os.stat(path)
        owned = not hasattr(os, "getuid") or st.st_uid == os.getuid()
        if owned and not (st.st_mode & 0o022):
            return path
    except OSError:
        pass
    path = tempfile.mkdtemp(prefix="cameo-scan-")   # per-process, private
    atexit.register(shutil.rmtree, path, True)
    return path


def _build_native():
    """Compile the scanner once per source hash; None when unavailable."""
    if os.environ.get("CAMEO_NATIVE_SCAN", "1") == "0":
        return None
    try:
        tag = hashlib.sha1(_C_SOURCE.encode()).hexdigest()[:16]
        so_path = os.path.join(_cache_dir(), f"cameo_scan_{tag}.so")
        if not os.path.exists(so_path):
            src = so_path[:-3] + ".c"
            with open(src, "w") as f:
                f.write(_C_SOURCE)
            tmp = so_path + f".{os.getpid()}.tmp"
            subprocess.run(
                ["cc", "-O2", "-shared", "-fPIC", "-o", tmp, src],
                check=True, capture_output=True, timeout=120)
            os.replace(tmp, so_path)          # atomic vs concurrent builds
    except Exception:
        return None
    try:
        lib = ctypes.CDLL(so_path)
        ptr = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
        outp = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
        for name in ("gorilla_scan", "chimp_scan", "index_scan"):
            fn = getattr(lib, name)
            fn.restype = ctypes.c_long
            fn.argtypes = [ptr, ctypes.c_long, outp]
        return lib
    except Exception:
        return None


# The native library is built lazily on the first scan call (not at import
# time): encode-only users — e.g. baselines/lossless pulling the Table 2
# counters through store.codec — never pay the cc subprocess.
_LIB = None
_TRIED = False


def _lib():
    global _LIB, _TRIED
    if not _TRIED:
        _LIB = _build_native()
        _TRIED = True
    return _LIB


def __getattr__(name):
    if name == "NATIVE":     # lazy module attribute: triggers the build
        return _lib() is not None
    raise AttributeError(f"module 'repro_torch.store._scan' has no attribute "
                         f"{name!r}")


# 24-bit window masks per bit misalignment (python fallback scans)
_WMASK = tuple((1 << (24 - r)) - 1 for r in range(8))


def _padded(data: bytes) -> np.ndarray:
    """Stream bytes with zero padding so 3-byte window reads never overrun."""
    return np.concatenate(
        [np.frombuffer(data, np.uint8), np.zeros(8, np.uint8)])


def _ctrl_windows(data: bytes) -> list:
    d = _padded(data).astype(np.uint32)
    return ((d[:-2] << np.uint32(16)) | (d[1:-1] << np.uint32(8))
            | d[2:]).tolist()


def _gorilla_scan_py(data: bytes, m: int) -> np.ndarray:
    win = _ctrl_windows(data)
    wmask = _WMASK
    acc = []
    append = acc.append
    bp = 64
    plz = ptz = -1
    i = 0
    while i < m:
        r = bp & 7
        x = win[bp >> 3] & wmask[r]
        avail = 24 - r
        if x < (1 << (avail - 1)):        # '0' — run of zero-xor records
            take = avail - x.bit_length()
            if take > m - i:
                take = m - i
            bp += take
            i += take
            continue
        w = x >> (avail - 13)
        if w < 0x1800:                    # '10' — reuse previous window
            sig = 64 - plz - ptz
            append((i << 15) | (sig << 7) | ptz)
            bp += 2 + sig
        else:                             # '11' — new window
            plz = (w >> 6) & 0x1F
            sig = (w & 0x3F) or 64
            ptz = 64 - plz - sig
            append((i << 15) | 0x4000 | (sig << 7) | ptz)
            bp += 13 + sig
        i += 1
    return np.asarray(acc, np.int64)


def _chimp_scan_py(data: bytes, m: int) -> np.ndarray:
    win = _ctrl_windows(data)
    wmask = _WMASK
    buckets = (0, 8, 12, 16, 18, 20, 22, 24)
    acc = []
    append = acc.append
    bp = 64
    prev_lzb = -1
    i = 0
    while i < m:
        r = bp & 7
        x = win[bp >> 3] & wmask[r]
        avail = 24 - r
        if x < (1 << (avail - 2)):        # '00' — run of zero-xor records
            take = (avail - x.bit_length()) >> 1
            if take > m - i:
                take = m - i
            bp += 2 * take
            i += take
            prev_lzb = -1
            continue
        w = x >> (avail - 11)
        c = w >> 9
        if c == 1:                        # '01' — center form
            lzb = buckets[(w >> 6) & 7]
            center = (w & 0x3F) or 64
            append((i << 15) | (1 << 13) | (center << 6)
                   | (64 - lzb - center))
            bp += 11 + center
            prev_lzb = -1
        elif c == 2:                      # '10' — bucket reuse
            width = 64 - prev_lzb
            append((i << 15) | (2 << 13) | (width << 6))
            bp += 2 + width
        else:                             # '11' — new bucket
            prev_lzb = buckets[(w >> 6) & 7]
            width = 64 - prev_lzb
            append((i << 15) | (3 << 13) | (width << 6))
            bp += 5 + width
        i += 1
    return np.asarray(acc, np.int64)


def _index_scan_py(data: bytes, m: int) -> np.ndarray:
    win = _ctrl_windows(data)
    wmask = _WMASK
    acc = []
    append = acc.append
    bp = 32
    i = 0
    while i < m:
        r = bp & 7
        x = win[bp >> 3] & wmask[r]
        avail = 24 - r
        if x < (1 << (avail - 1)):        # '0' — run of repeated deltas
            take = avail - x.bit_length()
            if take > m - i:
                take = m - i
            bp += take
            i += take
            continue
        w = x >> (avail - 4)
        if w < 0b1100:                    # '10'
            append(i << 2)
            bp += 2 + 7
        elif w < 0b1110:                  # '110'
            append((i << 2) | 1)
            bp += 3 + 9
        elif w == 0b1110:                 # '1110'
            append((i << 2) | 2)
            bp += 4 + 12
        else:                             # '1111' — wide
            append((i << 2) | 3)
            bp += 4 + 32
        i += 1
    return np.asarray(acc, np.int64)


def _native(lib, name, data: bytes, m: int) -> np.ndarray:
    out = np.empty(m, np.int64)
    k = getattr(lib, name)(_padded(data), m, out)
    return out[:k]


def gorilla_scan(data: bytes, m: int) -> np.ndarray:
    """Packed non-zero-record array for a Gorilla stream of ``m`` records:
    ``(i << 15) | (new_window << 14) | (sig << 7) | shift`` per entry."""
    lib = _lib()
    if lib is not None:
        return _native(lib, "gorilla_scan", data, m)
    return _gorilla_scan_py(data, m)


def chimp_scan(data: bytes, m: int) -> np.ndarray:
    """Packed non-zero-record array for a Chimp stream of ``m`` records:
    ``(i << 15) | (case << 13) | (width << 6) | shift`` per entry."""
    lib = _lib()
    if lib is not None:
        return _native(lib, "chimp_scan", data, m)
    return _chimp_scan_py(data, m)


def index_scan(data: bytes, m: int) -> np.ndarray:
    """Packed non-zero-record array for a dod index stream of ``m``
    records: ``(i << 2) | bucket`` per entry."""
    lib = _lib()
    if lib is not None:
        return _native(lib, "index_scan", data, m)
    return _index_scan_py(data, m)
