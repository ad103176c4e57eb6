"""Byte-true bitstream codecs for the CameoStore physical layer.

The paper's headline metric is a compression *ratio*, but ratios only mean
something once a byte stream exists.  This module materializes the two
streams a stored CAMEO series consists of:

* **kept-index stream** — delta-of-delta bit-packing in the Gorilla
  timestamp style ('0' for a repeated delta, then 7/9/12/32-bit buckets).
  CAMEO's kept indices are near-arithmetic at low CR (long runs of
  delta==const cost one bit per point) and stay cheap at high CR.
* **value stream** — Gorilla or Chimp XOR float codecs.  These are the
  *encoder* forms of the bit-cost counters in ``baselines/lossless.py``
  (Table 2): the branch plans are computed once here and shared by both the
  counters and the emitters, so counted bits == emitted bits exactly, by
  construction (and by test).

Both directions are numpy-vectorized (Sprintz's lesson: bit-packed
time-series codecs only pay off when decode is, PAPERS.md):

* **encode** — the branch plan yields one (value, width) field pair per
  record; :func:`_pack_fields` packs all fields in bulk (ragged bit
  scatter + ``np.packbits``).
* **decode** — a single cheap control-stream scan (a few integer ops per
  non-zero record; runs of zero-control records are consumed in bulk)
  recovers each record's branch case and payload bit offset, then
  :func:`_gather_fields` extracts every payload field in one shot and the
  value chains close with ``np.bitwise_xor.accumulate`` (XOR codecs) /
  second-order ``np.cumsum`` (delta-of-delta indices).

The original one-record-at-a-time forms are kept as ``*_loop`` parity
oracles: they pin the published encodings in their most literal shape, and
the property tests hold the vectorized paths bit-identical to them.

Both streams can be wrapped in an optional entropy stage (zstd when the
``zstandard`` module is present, stdlib zlib otherwise — the same fallback
discipline as ``checkpoint/manager.py``); the wrap is only kept when it
actually shrinks the payload, and the chosen codec is recorded so decode
never guesses.

Everything here is plain numpy + stdlib: no torch, importable from anywhere
(``baselines/lossless.py`` delegates its fast paths to the shared plans).
All value codecs operate on 64-bit IEEE doubles; float32 inputs are upcast
(exactly) and round-trip bit-true through a float32 cast on the way out.
"""
from __future__ import annotations

import zlib

import numpy as np

try:
    import zstandard
except ImportError:  # optional dep: entropy wrap falls back to stdlib zlib
    zstandard = None

VALUE_CODECS = ("gorilla", "chimp")
ENTROPY_CODECS = ("none", "zlib", "zstd")

_CHIMP_LZ_BUCKETS = np.array([0, 8, 12, 16, 18, 20, 22, 24])

_U64_ONE = np.uint64(1)


# ---------------------------------------------------------------------------
# bit-level IO (loop forms; the vectorized paths use _pack/_gather_fields)
# ---------------------------------------------------------------------------

class BitWriter:
    """MSB-first bit packer.  O(1) amortized per write; bounded accumulator."""

    __slots__ = ("_buf", "_acc", "_nacc", "bit_length")

    def __init__(self):
        self._buf = bytearray()
        self._acc = 0          # partial bits, < 8 of them after each write
        self._nacc = 0
        self.bit_length = 0

    def write(self, value: int, nbits: int):
        if nbits <= 0:
            return
        self.bit_length += nbits
        acc = (self._acc << nbits) | (int(value) & ((1 << nbits) - 1))
        nacc = self._nacc + nbits
        buf = self._buf
        while nacc >= 8:
            nacc -= 8
            buf.append((acc >> nacc) & 0xFF)
        self._acc = acc & ((1 << nacc) - 1)
        self._nacc = nacc

    def getvalue(self) -> bytes:
        if self._nacc:
            return bytes(self._buf) + bytes(
                [(self._acc << (8 - self._nacc)) & 0xFF])
        return bytes(self._buf)


class BitReader:
    """MSB-first bit reader over ``bytes`` (the BitWriter's inverse)."""

    __slots__ = ("_data", "_pos", "_acc", "_nacc")

    def __init__(self, data: bytes):
        self._data = data
        self._pos = 0
        self._acc = 0
        self._nacc = 0

    def read(self, nbits: int) -> int:
        if nbits <= 0:
            return 0
        acc, nacc, pos, data = self._acc, self._nacc, self._pos, self._data
        while nacc < nbits:
            acc = (acc << 8) | data[pos]
            pos += 1
            nacc += 8
        nacc -= nbits
        out = (acc >> nacc) & ((1 << nbits) - 1)
        self._acc = acc & ((1 << nacc) - 1)
        self._nacc = nacc
        self._pos = pos
        return out


# ---------------------------------------------------------------------------
# bulk bit framing (shared by the vectorized encoders AND decoders)
# ---------------------------------------------------------------------------

def _pack_fields(values, widths) -> bytes:
    """Pack bit-fields MSB-first: field ``k`` occupies ``widths[k]`` bits
    starting at ``sum(widths[:k])`` — the vectorized form of a
    ``BitWriter.write`` loop (bit-identical output, including the zero-pad
    of the final partial byte).  Zero-width fields emit nothing; values
    wider than their field are truncated to the low ``width`` bits, like
    ``BitWriter.write``'s mask.

    Works in the bit domain with uint8 C kernels only: each value explodes
    to its 64 MSB-first bits (``np.unpackbits``), a ragged row mask keeps
    the low ``width`` bits of every row, and the boolean fancy-index
    concatenates them in stream order for ``np.packbits``.
    """
    widths = np.asarray(widths, np.int64)
    total = int(widths.sum())
    if total == 0:
        return b""
    nz = widths > 0
    v = np.ascontiguousarray(np.asarray(values, np.uint64)[nz])
    wd = widths[nz]
    bits64 = np.unpackbits(v.byteswap().view(np.uint8)).reshape(-1, 64)
    keep = np.arange(64) >= (64 - wd)[:, None]
    return np.packbits(bits64[keep]).tobytes()


def _gather_fields(data: bytes, starts, widths) -> np.ndarray:
    """Extract bit-fields from an MSB-first stream: field ``k`` is
    ``widths[k]`` bits at absolute bit offset ``starts[k]`` — the
    vectorized form of a ``BitReader.read`` loop.  Returns uint64 values
    (0 where ``width == 0``).

    Each field spans at most 9 bytes (64 bits + 7 bits of misalignment),
    so one ``[k, 9]`` byte-window gather + a big-endian view + two shifts
    recover every field at once.
    """
    widths = np.asarray(widths, np.int64)
    out = np.zeros(widths.shape[0], np.uint64)
    nz = widths > 0
    wd = widths[nz]
    if wd.shape[0] == 0:
        return out
    pos = np.asarray(starts, np.int64)[nz]
    d = np.frombuffer(data, np.uint8)
    d = np.concatenate([d, np.zeros(9, np.uint8)])
    r = (pos & 7).astype(np.uint64)
    win = d[(pos >> 3)[:, None] + np.arange(9)]
    w64 = np.ascontiguousarray(win[:, :8]).view(">u8")[:, 0].astype(np.uint64)
    b8 = win[:, 8].astype(np.uint64)
    aligned = (w64 << r) | (b8 >> (np.uint64(8) - r))   # bits [pos, pos+64)
    out[nz] = aligned >> (np.uint64(64) - wd.astype(np.uint64))
    return out


# The sequential control-stream scans (the only non-bulk part of decode)
# live in store/_scan.py: native C via ctypes when a compiler is around,
# pure-Python 24-bit-window fallback otherwise — identical packed output.
from repro_torch.store import _scan


# ---------------------------------------------------------------------------
# vectorized XOR bit-geometry (shared by counters and encoders)
# ---------------------------------------------------------------------------

def bit_length_u64(v: np.ndarray) -> np.ndarray:
    """Vectorized ``int.bit_length`` for a uint64 array (0 -> 0).

    Binary-search over shifted masks — exact for the full 64-bit range
    (float log2 would mis-round near powers of two above 2**53).
    """
    v = np.asarray(v, np.uint64).copy()
    bl = np.zeros(v.shape, np.int64)
    for s in (32, 16, 8, 4, 2, 1):
        su = np.uint64(s)
        big = v >= (_U64_ONE << su)
        bl[big] += s
        v[big] >>= su
    bl += (v != 0)
    return bl


def xor_parts(x: np.ndarray):
    """(bits, xor, lz, tz) of a float64 series, fully vectorized.

    ``xor[i] = bits[i+1] ^ bits[i]``; ``lz``/``tz`` are leading/trailing zero
    counts of each xor (64 for xor == 0) — the vectorized form of the
    per-value Python loop the Table 2 counters used to run.
    """
    bits = np.ascontiguousarray(np.asarray(x, np.float64)).view(np.uint64)
    xor = bits[1:] ^ bits[:-1]
    bl = bit_length_u64(xor)
    lz = np.where(xor == 0, 64, 64 - bl)
    lowbit = xor & (~xor + _U64_ONE)
    tz = np.where(xor == 0, 64, bit_length_u64(lowbit) - 1)
    return bits, xor, lz.astype(np.int64), tz.astype(np.int64)


# ---------------------------------------------------------------------------
# Gorilla value codec (Pelkonen et al. 2015)
# ---------------------------------------------------------------------------

def _gorilla_plan(xor, lz, tz):
    """Branch plan for the Gorilla value stream.

    Returns ``(case, sig, shift)`` aligned with ``xor``: case 0 = zero xor
    ('0'), 1 = window reuse ('10' + sig bits), 2 = new window ('11' + 5-bit
    LZ + 6-bit length + sig bits); ``shift`` is the right-shift producing the
    emitted meaningful bits.  The meaningful-bit *window* chain is inherently
    sequential (each reuse decision depends on the last reset), so this scan
    runs in Python — but over the precomputed vectorized bit geometry, which
    is where the old per-value loops spent their time.
    """
    m = xor.shape[0]
    li_l = np.minimum(lz, 31).tolist()    # gorilla caps LZ at 31 (5-bit field)
    tz_l = tz.tolist()
    nz_l = (xor != 0).tolist()
    case = [0] * m
    sig = [0] * m
    shift = [0] * m
    plz, ptz = -1, -1
    for i in range(m):
        if not nz_l[i]:
            continue
        li, ti = li_l[i], tz_l[i]
        if plz >= 0 and li >= plz and ti >= ptz:
            case[i] = 1
            sig[i] = 64 - plz - ptz
            shift[i] = ptz
        else:
            case[i] = 2
            sig[i] = 64 - li - ti
            shift[i] = ti
            plz, ptz = li, ti
    return (np.asarray(case, np.int64), np.asarray(sig, np.int64),
            np.asarray(shift, np.int64))


def gorilla_stream_bits(x) -> int:
    """Exact bit size of :func:`gorilla_encode`'s stream (vectorized tally)."""
    x = np.asarray(x, np.float64)
    if x.shape[0] == 0:
        return 0
    _, xor, lz, tz = xor_parts(x)
    case, sig, _ = _gorilla_plan(xor, lz, tz)
    bits = np.where(case == 0, 1,
                    np.where(case == 1, 2 + sig, 2 + 5 + 6 + sig))
    return 64 + int(bits.sum())


def gorilla_encode(x) -> bytes:
    """Gorilla XOR value stream for a float64 series (lossless).

    Vectorized: the branch plan maps each record to one header field and
    one payload field; :func:`_pack_fields` packs the whole stream in bulk.
    Byte-identical to :func:`gorilla_encode_loop`.
    """
    x = np.asarray(x, np.float64)
    n = x.shape[0]
    if n == 0:
        return b""
    bits, xor, lz, tz = xor_parts(x)
    case, sig, shift = _gorilla_plan(xor, lz, tz)
    m = xor.shape[0]
    li = 64 - sig - shift                 # the capped LZ, for case-2 headers
    hdr_val = np.where(case == 0, 0,
                       np.where(case == 1, 0b10,
                                (0b11 << 11) | (li << 6) | (sig & 0x3F)))
    hdr_w = np.where(case == 0, 1, np.where(case == 1, 2, 13))
    pay_val = xor >> np.minimum(shift, 63).astype(np.uint64)
    pay_w = np.where(case == 0, 0, sig)
    vals = np.empty(1 + 2 * m, np.uint64)
    wids = np.empty(1 + 2 * m, np.int64)
    vals[0], wids[0] = bits[0], 64
    vals[1::2], wids[1::2] = hdr_val, hdr_w
    vals[2::2], wids[2::2] = pay_val, pay_w
    return _pack_fields(vals, wids)


def gorilla_decode(data: bytes, n: int) -> np.ndarray:
    """Inverse of :func:`gorilla_encode`; returns float64 [n].

    Vectorized: one control-stream scan recovers each record's payload bit
    offset/width (runs of '0' control bits — zero xors — are consumed in
    bulk straight off the 24-bit windows), payloads are gathered in one
    :func:`_gather_fields` call, and the XOR chain closes with
    ``np.bitwise_xor.accumulate``.  Bit-true inverse, property-tested
    against :func:`gorilla_decode_loop`.
    """
    if n == 0:
        return np.empty(0, np.uint64).view(np.float64)
    a = _scan.gorilla_scan(data, n - 1)
    stream = np.zeros(n, np.uint64)
    stream[0] = int.from_bytes(data[:8], "big")   # MSB-first head field
    if a.shape[0]:
        ri = a >> 15
        sig = (a >> 7) & 0x7F
        hdr_w = np.where(a & 0x4000, 13, 2)
        body = hdr_w + sig
        # payload offsets: 64 head bits + 1 bit per preceding zero-xor
        # record + every preceding non-zero record's header + payload
        pos = (64 + (ri - np.arange(ri.shape[0]))
               + np.cumsum(body) - body + hdr_w)
        xors = _gather_fields(data, pos, sig)
        stream[ri + 1] = xors << (a & 0x3F).astype(np.uint64)
    return np.bitwise_xor.accumulate(stream).view(np.float64)


def gorilla_encode_loop(x) -> bytes:
    """Parity oracle: :func:`gorilla_encode` as the literal per-record
    ``BitWriter`` loop the published scheme describes."""
    x = np.asarray(x, np.float64)
    n = x.shape[0]
    w = BitWriter()
    if n == 0:
        return w.getvalue()
    bits, xor, lz, tz = xor_parts(x)
    w.write(int(bits[0]), 64)
    case, sig, shift = _gorilla_plan(xor, lz, tz)
    xor_l, sig_l, shift_l = xor.tolist(), sig.tolist(), shift.tolist()
    for i, c in enumerate(case.tolist()):
        if c == 0:
            w.write(0, 1)
        elif c == 1:
            w.write(0b10, 2)
            w.write(xor_l[i] >> shift_l[i], sig_l[i])
        else:
            w.write(0b11, 2)
            w.write(64 - sig_l[i] - shift_l[i], 5)
            w.write(sig_l[i] & 0x3F, 6)        # 64 wraps to 0; decode maps back
            w.write(xor_l[i] >> shift_l[i], sig_l[i])
    return w.getvalue()


def gorilla_decode_loop(data: bytes, n: int) -> np.ndarray:
    """Parity oracle: :func:`gorilla_decode` as the literal per-record
    ``BitReader`` loop."""
    out = np.empty(n, np.uint64)
    if n == 0:
        return out.view(np.float64)
    r = BitReader(data)
    prev = r.read(64)
    out[0] = prev
    plz, ptz = -1, -1
    for i in range(1, n):
        if r.read(1):
            if r.read(1):                       # '11' — new window
                li = r.read(5)
                sig = r.read(6) or 64
                ti = 64 - li - sig
                xor = r.read(sig) << ti
                plz, ptz = li, ti
            else:                               # '10' — reuse window
                xor = r.read(64 - plz - ptz) << ptz
            prev ^= xor
        out[i] = prev
    return out.view(np.float64)


# ---------------------------------------------------------------------------
# Chimp value codec (Liakos et al. 2022, plain variant)
# ---------------------------------------------------------------------------

def _chimp_plan(xor, lz, tz):
    """Branch plan for the (plain) Chimp stream — fully vectorized.

    Chimp's only carried state is the previous leading-zero bucket, and it is
    a function of the *previous element alone* (zero-xor and center-form
    entries reset it), so unlike Gorilla there is no sequential chain.

    Returns ``(case, lzb, bi)``: case 0 = zero xor, 1 = center form
    (tz > 6), 2 = bucket reuse, 3 = new bucket; ``lzb`` the rounded
    leading-zero bucket, ``bi`` its 3-bit index.
    """
    bi = np.searchsorted(_CHIMP_LZ_BUCKETS, np.minimum(lz, 24),
                         side="right") - 1
    lzb = _CHIMP_LZ_BUCKETS[bi]
    resets = (xor == 0) | (tz > 6)
    prev_bucket = np.concatenate(
        [[-1], np.where(resets[:-1], -1, lzb[:-1])])
    case = np.where(xor == 0, 0,
                    np.where(tz > 6, 1,
                             np.where(lzb == prev_bucket, 2, 3)))
    return case.astype(np.int64), lzb.astype(np.int64), bi.astype(np.int64)


def chimp_stream_bits(x) -> int:
    """Exact bit size of :func:`chimp_encode`'s stream (vectorized tally)."""
    x = np.asarray(x, np.float64)
    if x.shape[0] == 0:
        return 0
    _, xor, lz, tz = xor_parts(x)
    case, lzb, _ = _chimp_plan(xor, lz, tz)
    center = np.maximum(64 - lzb - tz, 0)
    bits = np.where(case == 0, 2,
                    np.where(case == 1, 2 + 3 + 6 + center,
                             np.where(case == 2, 2 + (64 - lzb),
                                      2 + 3 + (64 - lzb))))
    return 64 + int(bits.sum())


def chimp_encode(x) -> bytes:
    """Chimp XOR value stream for a float64 series (lossless).

    Vectorized bulk packing; byte-identical to :func:`chimp_encode_loop`.
    """
    x = np.asarray(x, np.float64)
    n = x.shape[0]
    if n == 0:
        return b""
    bits, xor, lz, tz = xor_parts(x)
    case, lzb, bi = _chimp_plan(xor, lz, tz)
    m = xor.shape[0]
    center = np.maximum(64 - lzb - tz, 0)
    hdr_val = np.select(
        [case == 0, case == 1, case == 2],
        [0, (0b01 << 9) | (bi << 6) | (center & 0x3F), 0b10],
        default=(0b11 << 3) | bi)
    hdr_w = np.select([case == 0, case == 1, case == 2], [2, 11, 2],
                      default=5)
    pay_val = np.where(case == 1,
                       xor >> np.minimum(tz, 63).astype(np.uint64), xor)
    pay_w = np.select([case == 0, case == 1], [0, center],
                      default=64 - lzb)
    vals = np.empty(1 + 2 * m, np.uint64)
    wids = np.empty(1 + 2 * m, np.int64)
    vals[0], wids[0] = bits[0], 64
    vals[1::2], wids[1::2] = hdr_val, hdr_w
    vals[2::2], wids[2::2] = pay_val, pay_w
    return _pack_fields(vals, wids)


def chimp_decode(data: bytes, n: int) -> np.ndarray:
    """Inverse of :func:`chimp_encode`; returns float64 [n].

    Vectorized control-scan + bulk gather + ``np.bitwise_xor.accumulate``,
    like :func:`gorilla_decode` ('00' zero-xor runs consumed in bulk).
    Bit-true inverse, property-tested against :func:`chimp_decode_loop`.
    """
    if n == 0:
        return np.empty(0, np.uint64).view(np.float64)
    a = _scan.chimp_scan(data, n - 1)
    stream = np.zeros(n, np.uint64)
    stream[0] = int.from_bytes(data[:8], "big")   # MSB-first head field
    if a.shape[0]:
        ri = a >> 15
        width = (a >> 6) & 0x7F
        hdr_w = np.array([0, 11, 2, 5])[(a >> 13) & 3]
        body = hdr_w + width
        # payload offsets: 64 head bits + 2 bits per preceding zero-xor
        # record + every preceding non-zero record's header + payload
        pos = (64 + 2 * (ri - np.arange(ri.shape[0]))
               + np.cumsum(body) - body + hdr_w)
        xors = _gather_fields(data, pos, width)
        stream[ri + 1] = xors << (a & 0x3F).astype(np.uint64)
    return np.bitwise_xor.accumulate(stream).view(np.float64)


def chimp_encode_loop(x) -> bytes:
    """Parity oracle: :func:`chimp_encode` as the literal per-record
    ``BitWriter`` loop."""
    x = np.asarray(x, np.float64)
    n = x.shape[0]
    w = BitWriter()
    if n == 0:
        return w.getvalue()
    bits, xor, lz, tz = xor_parts(x)
    w.write(int(bits[0]), 64)
    case, lzb, bi = _chimp_plan(xor, lz, tz)
    xor_l, tz_l = xor.tolist(), tz.tolist()
    lzb_l, bi_l = lzb.tolist(), bi.tolist()
    for i, c in enumerate(case.tolist()):
        if c == 0:
            w.write(0b00, 2)
        elif c == 1:
            center = max(64 - lzb_l[i] - tz_l[i], 0)
            w.write(0b01, 2)
            w.write(bi_l[i], 3)
            w.write(center & 0x3F, 6)
            w.write(xor_l[i] >> tz_l[i], center)
        elif c == 2:
            w.write(0b10, 2)
            w.write(xor_l[i], 64 - lzb_l[i])
        else:
            w.write(0b11, 2)
            w.write(bi_l[i], 3)
            w.write(xor_l[i], 64 - lzb_l[i])
    return w.getvalue()


def chimp_decode_loop(data: bytes, n: int) -> np.ndarray:
    """Parity oracle: :func:`chimp_decode` as the literal per-record
    ``BitReader`` loop."""
    out = np.empty(n, np.uint64)
    if n == 0:
        return out.view(np.float64)
    r = BitReader(data)
    prev = r.read(64)
    out[0] = prev
    buckets = _CHIMP_LZ_BUCKETS.tolist()
    prev_lzb = -1
    for i in range(1, n):
        c = r.read(2)
        if c == 0b00:
            xor = 0
            prev_lzb = -1
        elif c == 0b01:
            lzb = buckets[r.read(3)]
            center = r.read(6) or 64
            ti = 64 - lzb - center
            xor = r.read(center) << ti
            prev_lzb = -1
        elif c == 0b10:
            xor = r.read(64 - prev_lzb)
        else:
            prev_lzb = buckets[r.read(3)]
            xor = r.read(64 - prev_lzb)
        prev ^= xor
        out[i] = prev
    return out.view(np.float64)


VALUE_ENCODERS = {"gorilla": gorilla_encode, "chimp": chimp_encode}
VALUE_DECODERS = {"gorilla": gorilla_decode, "chimp": chimp_decode}
VALUE_ENCODERS_LOOP = {"gorilla": gorilla_encode_loop,
                       "chimp": chimp_encode_loop}
VALUE_DECODERS_LOOP = {"gorilla": gorilla_decode_loop,
                       "chimp": chimp_decode_loop}
VALUE_BIT_COUNTERS = {"gorilla": gorilla_stream_bits,
                      "chimp": chimp_stream_bits}


# ---------------------------------------------------------------------------
# kept-index stream: delta-of-delta bit packing (Gorilla timestamp style)
# ---------------------------------------------------------------------------

# (control bits, control width, payload bits, payload offset) per bucket;
# dod in [lo, hi] is stored as dod - lo in `payload bits` bits.
_DOD_BUCKETS = (
    (0b10, 2, 7, -63),       # dod in [-63, 64]
    (0b110, 3, 9, -255),     # dod in [-255, 256]
    (0b1110, 4, 12, -2047),  # dod in [-2047, 2048]
)
_DOD_WIDE_CTRL, _DOD_WIDE_CTRLW, _DOD_WIDE_BITS = 0b1111, 4, 32
_DOD_LOS = np.array([lo for *_, lo in _DOD_BUCKETS] + [0], np.int64)


def _dod_terms(idx: np.ndarray):
    idx = np.asarray(idx, np.int64)
    deltas = np.diff(idx)
    if np.any(deltas <= 0):
        raise ValueError("kept indices must be strictly increasing")
    dods = np.diff(deltas, prepend=np.int64(1))  # first delta vs implicit 1
    if dods.size and np.abs(dods).max() >= (1 << 31):
        raise ValueError("index delta-of-delta outside the 32-bit bucket")
    return dods


def index_stream_bits(idx) -> int:
    """Exact bit size of :func:`encode_indices`' stream (vectorized tally)."""
    idx = np.asarray(idx, np.int64)
    if idx.shape[0] == 0:
        return 0
    dods = _dod_terms(idx)
    bits = np.full(dods.shape, _DOD_WIDE_CTRLW + _DOD_WIDE_BITS, np.int64)
    for ctrl, cw, pb, lo in reversed(_DOD_BUCKETS):
        hi = lo + (1 << pb) - 1
        bits = np.where((dods >= lo) & (dods <= hi), cw + pb, bits)
    bits = np.where(dods == 0, 1, bits)
    return 32 + int(bits.sum())


def encode_indices(idx) -> bytes:
    """Delta-of-delta stream for strictly-increasing int indices.

    The first index is stored in 32 raw bits; the first delta is coded as a
    dod against an implicit previous delta of 1 (the unit-stride prior —
    CAMEO kept sets at moderate CR are long runs of consecutive indices,
    which cost one bit per point here).  Vectorized bulk packing;
    byte-identical to :func:`encode_indices_loop`.
    """
    idx = np.asarray(idx, np.int64)
    if idx.shape[0] == 0:
        return b""
    if not (0 <= idx[0] < (1 << 32)):
        raise ValueError(f"first index {idx[0]} outside u32 range")
    dods = _dod_terms(idx)
    m = dods.shape[0]
    hdr_val = np.zeros(m, np.int64)
    hdr_w = np.ones(m, np.int64)
    pay_val = np.zeros(m, np.int64)
    pay_w = np.zeros(m, np.int64)
    left = dods != 0
    for ctrl, cw, pb, lo in _DOD_BUCKETS:
        hi = lo + (1 << pb) - 1
        sel = left & (dods >= lo) & (dods <= hi)
        hdr_val[sel] = ctrl
        hdr_w[sel] = cw
        pay_val[sel] = dods[sel] - lo
        pay_w[sel] = pb
        left &= ~sel
    hdr_val[left] = _DOD_WIDE_CTRL
    hdr_w[left] = _DOD_WIDE_CTRLW
    pay_val[left] = dods[left] & 0xFFFFFFFF
    pay_w[left] = _DOD_WIDE_BITS
    vals = np.empty(1 + 2 * m, np.uint64)
    wids = np.empty(1 + 2 * m, np.int64)
    vals[0], wids[0] = int(idx[0]), 32
    vals[1::2], wids[1::2] = hdr_val, hdr_w
    vals[2::2], wids[2::2] = pay_val, pay_w
    return _pack_fields(vals, wids)


def decode_indices(data: bytes, count: int) -> np.ndarray:
    """Inverse of :func:`encode_indices`; returns int64 [count].

    Vectorized control-scan (runs of '0' — repeated deltas — consumed in
    bulk) + one payload gather; the index chain closes with second-order
    ``np.cumsum`` (dod -> delta -> index).  Bit-true inverse,
    property-tested against :func:`decode_indices_loop`.
    """
    if count == 0:
        return np.empty(0, np.int64)
    m = count - 1
    a = _scan.index_scan(data, m)
    idx0 = int.from_bytes(data[:4], "big")        # MSB-first head field
    dods = np.zeros(m, np.int64)
    if a.shape[0]:
        ri = a >> 2
        bucket = a & 3
        hdr_w = np.array([2, 3, 4, 4])[bucket]
        width = np.array([7, 9, 12, 32])[bucket]
        body = hdr_w + width
        # payload offsets: 32 head bits + 1 bit per preceding repeated
        # delta + every preceding non-zero record's control + payload
        pos = (32 + (ri - np.arange(ri.shape[0]))
               + np.cumsum(body) - body + hdr_w)
        raw = _gather_fields(data, pos, width).astype(np.int64)
        dod = raw + _DOD_LOS[bucket]
        wide = bucket == 3
        dod[wide] = np.where(raw[wide] >= (1 << 31),
                             raw[wide] - (1 << 32), raw[wide])
        dods[ri] = dod
    deltas = np.cumsum(dods) + 1          # delta chain starts at implicit 1
    out = np.empty(count, np.int64)
    out[0] = idx0
    out[1:] = idx0 + np.cumsum(deltas)
    return out


def encode_indices_loop(idx) -> bytes:
    """Parity oracle: :func:`encode_indices` as the literal per-record
    ``BitWriter`` loop."""
    idx = np.asarray(idx, np.int64)
    w = BitWriter()
    if idx.shape[0] == 0:
        return w.getvalue()
    if not (0 <= idx[0] < (1 << 32)):
        raise ValueError(f"first index {idx[0]} outside u32 range")
    w.write(int(idx[0]), 32)
    for dod in _dod_terms(idx).tolist():
        if dod == 0:
            w.write(0, 1)
            continue
        for ctrl, cw, pb, lo in _DOD_BUCKETS:
            hi = lo + (1 << pb) - 1
            if lo <= dod <= hi:
                w.write(ctrl, cw)
                w.write(dod - lo, pb)
                break
        else:
            w.write(_DOD_WIDE_CTRL, _DOD_WIDE_CTRLW)
            w.write(dod & 0xFFFFFFFF, _DOD_WIDE_BITS)
    return w.getvalue()


def decode_indices_loop(data: bytes, count: int) -> np.ndarray:
    """Parity oracle: :func:`decode_indices` as the literal per-record
    ``BitReader`` loop."""
    out = np.empty(count, np.int64)
    if count == 0:
        return out
    r = BitReader(data)
    cur = r.read(32)
    out[0] = cur
    delta = 1
    for i in range(1, count):
        if r.read(1) == 0:
            dod = 0
        else:
            for ctrl, cw, pb, lo in _DOD_BUCKETS:
                if r.read(1) == 0:               # matched this bucket's ctrl
                    dod = r.read(pb) + lo
                    break
            else:
                raw = r.read(_DOD_WIDE_BITS)
                dod = raw - (1 << 32) if raw >= (1 << 31) else raw
        delta += dod
        cur += delta
        out[i] = cur
    return out


# ---------------------------------------------------------------------------
# entropy wrap (checkpoint/manager.py fallback discipline)
# ---------------------------------------------------------------------------

def entropy_wrap(raw: bytes, codec: str = "auto"):
    """Optionally entropy-code ``raw``.  Returns ``(payload, codec_used)``;
    the wrap is dropped (``"none"``) whenever it does not shrink the bytes.
    """
    if codec == "none":
        return raw, "none"
    if codec not in ("auto", "zstd", "zlib"):
        raise ValueError(f"unknown entropy codec {codec!r}")
    if codec in ("auto", "zstd") and zstandard is not None:
        comp = zstandard.ZstdCompressor(level=3).compress(raw)
        name = "zstd"
    else:
        comp = zlib.compress(raw, 6)
        name = "zlib"
    if len(comp) < len(raw):
        return comp, name
    return raw, "none"


def entropy_unwrap(payload: bytes, codec: str) -> bytes:
    if codec == "none":
        return payload
    if codec == "zstd":
        if zstandard is None:
            raise IOError("block is zstd-compressed but the zstandard "
                          "module is not installed")
        return zstandard.ZstdDecompressor().decompress(payload)
    if codec == "zlib":
        return zlib.decompress(payload)
    raise ValueError(f"unknown entropy codec {codec!r}")


# ---------------------------------------------------------------------------
# byte-true compression ratios
# ---------------------------------------------------------------------------

def encode_series_payload(indices, values, *, value_codec: str = "gorilla",
                          entropy: str = "auto"):
    """Encode one series' kept set as (index stream || value stream).

    Returns ``(payload, info)`` where ``info`` records the pre-wrap bit
    sizes and the entropy codec actually used.  This is the codec-only
    payload (no block headers) — the honest numerator for Table-2-style
    bits-per-value comparisons.
    """
    idx_bytes = encode_indices(indices)
    val_bytes = VALUE_ENCODERS[value_codec](values)
    raw = (len(idx_bytes).to_bytes(4, "little") + idx_bytes + val_bytes)
    payload, used = entropy_wrap(raw, entropy)
    info = dict(idx_bits=index_stream_bits(indices),
                val_bits=VALUE_BIT_COUNTERS[value_codec](values),
                raw_nbytes=len(raw), nbytes=len(payload),
                entropy=used, value_codec=value_codec)
    return payload, info


def decode_series_payload(payload: bytes, n_kept: int, entropy: str,
                          value_codec: str = "gorilla"):
    """Inverse of :func:`encode_series_payload` -> (indices, values)."""
    raw = entropy_unwrap(payload, entropy)
    idx_len = int.from_bytes(raw[:4], "little")
    idx = decode_indices(raw[4:4 + idx_len], n_kept)
    vals = VALUE_DECODERS[value_codec](raw[4 + idx_len:], n_kept)
    return idx, vals


def compression_ratio_bytes(res, *, value_codec: str = "gorilla",
                            entropy: str = "auto") -> float:
    """Byte-true CR: raw float64 bytes over encoded-payload bytes.

    The point-count CR (``core.cameo.compression_ratio``) divides *counts*;
    this divides *bytes*, with the kept set actually materialized through
    the index + value codecs (entropy-wrapped).  ``res`` is a
    ``CompressResult`` (or anything with ``.kept`` / ``.xr``).
    """
    # cameo does not import the store
    from repro_torch.core.cameo import kept_points
    idx, vals = kept_points(res)
    n = int(res.kept.shape[0])
    payload, _ = encode_series_payload(idx, vals, value_codec=value_codec,
                                       entropy=entropy)
    return (8.0 * n) / max(len(payload), 1)
