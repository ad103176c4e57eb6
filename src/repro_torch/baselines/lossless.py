"""Lossless XOR-based compressors (Table 2): Gorilla and Chimp bit costs
(port of ``repro/baselines/lossless.py``).

The public functions count exact bitstream sizes (bits-per-value) — that is
all the paper's Table 2 uses.  They delegate to the store's codec
(``store/codec.py``'s ``gorilla_stream_bits`` / ``chimp_stream_bits``, the
branch plans its encoders emit), so counted bits equal emitted bits by
construction.  The per-value Python loops are kept as ``*_loop`` oracle
forms: they pin the published encodings in their most literal shape for
the parity tests.

These are host functions over a numpy series, as in the reference: a
bit count has nothing to compute on the card.

Encodings follow the published schemes; Chimp uses the plain (non-128)
variant with the paper's rounded leading-zero buckets.
"""
from __future__ import annotations

import numpy as np

from repro_torch.store.codec import chimp_stream_bits, gorilla_stream_bits

_CHIMP_LZ_BUCKETS = np.array([0, 8, 12, 16, 18, 20, 22, 24])


def gorilla_bits_per_value(x) -> float:
    """Gorilla (Pelkonen et al. 2015) value encoding, 64-bit floats.

    Vectorized (shared with ``store/codec.py``'s encoder); bit-identical to
    :func:`gorilla_bits_per_value_loop`.
    """
    x = np.asarray(x, np.float64)
    n = x.shape[0]
    if n == 0:
        return 0.0
    return gorilla_stream_bits(x) / n


def chimp_bits_per_value(x) -> float:
    """Chimp (Liakos et al. 2022), plain variant with LZ bucket rounding.

    Vectorized (shared with ``store/codec.py``'s encoder); bit-identical to
    :func:`chimp_bits_per_value_loop`.
    """
    x = np.asarray(x, np.float64)
    n = x.shape[0]
    if n == 0:
        return 0.0
    return chimp_stream_bits(x) / n


# ---------------------------------------------------------------------------
# literal per-value loop forms — parity oracles for the vectorized paths
# ---------------------------------------------------------------------------

def _bit_parts(x: np.ndarray):
    bits = np.ascontiguousarray(np.asarray(x, np.float64)).view(np.uint64)
    xor = bits[1:] ^ bits[:-1]
    xor_py = [int(v) for v in xor]
    lz = np.array([64 - v.bit_length() if v else 64 for v in xor_py])
    tz = np.array([((v & -v).bit_length() - 1) if v else 64 for v in xor_py])
    return xor_py, lz, tz


def gorilla_bits_per_value_loop(x) -> float:
    """Reference form of :func:`gorilla_bits_per_value` (per-value loop)."""
    x = np.asarray(x, np.float64)
    n = x.shape[0]
    if n == 0:
        return 0.0
    xor, lz, tz = _bit_parts(x)
    total = 64  # first value verbatim
    plz, ptz = -1, -1  # previous meaningful-bit window
    for i in range(n - 1):
        if xor[i] == 0:
            total += 1
            continue
        li = min(int(lz[i]), 31)  # gorilla caps LZ at 31 (5-bit field)
        ti = int(tz[i])
        if plz >= 0 and li >= plz and ti >= ptz:
            total += 2 + (64 - plz - ptz)
        else:
            sig = 64 - li - ti
            total += 2 + 5 + 6 + sig
            plz, ptz = li, ti
    return total / n


def chimp_bits_per_value_loop(x) -> float:
    """Reference form of :func:`chimp_bits_per_value` (per-value loop)."""
    x = np.asarray(x, np.float64)
    n = x.shape[0]
    if n == 0:
        return 0.0
    xor, lz, tz = _bit_parts(x)
    total = 64
    prev_lz_bucket = -1
    for i in range(n - 1):
        if xor[i] == 0:
            total += 2
            prev_lz_bucket = -1
            continue
        lzb = int(_CHIMP_LZ_BUCKETS[np.searchsorted(
            _CHIMP_LZ_BUCKETS, min(int(lz[i]), 24), side="right") - 1])
        ti = int(tz[i])
        if ti > 6:
            # '01': 3-bit LZ bucket + 6-bit significant length + center bits
            center = 64 - lzb - ti
            total += 2 + 3 + 6 + max(center, 0)
            prev_lz_bucket = -1
        elif lzb == prev_lz_bucket:
            total += 2 + (64 - lzb)
        else:
            total += 2 + 3 + (64 - lzb)
            prev_lz_bucket = lzb
    return total / n
