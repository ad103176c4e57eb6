"""Chunked block format for stored CAMEO series.

A stored series is a sequence of blocks whose borders sit **on kept
points** — the writer snaps nominal ``block_len`` boundaries forward to the
next kept index, and consecutive blocks share that boundary point.  This is
the same discipline as ``core/parallel``'s pinned partition borders: no
interpolation segment ever crosses a block, so a block decodes to the exact
reconstruction slice using only its own kept points, and window reads touch
only overlapping blocks.

Every block header carries the compression contract (``n``, ``n_kept``,
``eps``, ``stat``, ``kappa``, ``L``) plus the pushdown metadata
``store/query.py`` answers aggregates from:

* the five per-lag ACF sufficient statistics of the block's owned slice
  (Eq. 7: ``sx, sxl, sx2, sxl2, sxx``, each ``[L]``);
* value moments (sum, sum of squares, min, max) and the first/last ``L``
  reconstruction values (the cross-block lag products for windowed ACF);
* signed residual moments vs the *original* series when the writer had it
  (``sum e``, ``sum e^2``, ``sum xr*e``, ``max |e|``) — the Plato-style
  deterministic error-bound inputs.

Header metadata is stored **compacted** twice over.  First, the moment
rows are *derived, not stored* (format v3): of the five Eq. 7 rows only
the lagged products ``sxx`` are physically kept — ``sx``, ``sxl``,
``sx2`` and ``sxl2`` are reconstructed at parse time from the scalar
moments plus the first/last-``L`` edge vectors the header already
carries (``sx(l) = vsum - sum(last l values)`` and mirrored forms; the
exact derivation ``store/query.py`` has always used for windowed ACF).
That shrinks the stored per-lag metadata ``(5L + |hv| + |tv|) /
(L + |hv| + |tv|)`` ≈ 2.3x on top of the coding below.  The derived rows
are *exact-on-derivation* (deterministic, equal to the v2 stored values
up to summation-order rounding); ``sxx`` — the only row the pushdown
ACF consumes from metadata — stays bit-exact.  v2 blocks (which store
all five rows) are still parsed bit-exactly; the block flags byte says
which layout a body uses.

Second, the surviving vectors (``sxx`` + the two edge vectors) go
through a lossless xor-delta over the float64 bit patterns followed by
a byte-plane shuffle (the blosc/Sprintz filter idea) and the shared
entropy wrap.  Neighboring entries share exponent and high mantissa
bytes, so the deltas are mostly-zero byte planes that zlib/zstd
collapse — min_temp-style ``L=365`` headers stop dominating their
payloads.  That roundtrip is bit-exact (uint64 xor + ``np.bitwise_xor.
accumulate``), so the deterministic pushdown bounds in ``store/query.py``
are untouched.

Ownership is half-open: block ``i`` owns ``[t0, t1)`` (the shared right
border belongs to the next block) except the last block, which owns its end
point too.  Owned spans are kept ``>= L`` (tail blocks merge into their
predecessor) so cross-block lag pairs only ever straddle *adjacent* blocks.

Reconstruction goes through the compressor's own interpolation
(``core.cameo._reconstruct``) on the store's device, so a block decodes
to the bits of the matching slice of ``CompressResult.xr``.  The JAX
package pads a block to a power-of-two length only to bound its jit
shapes; the port runs eagerly and reconstructs the block's span as it
is, which gives the same bits because a block's last point is kept.
(XLA's default compilation contracts the interpolation into a fused
multiply-add; the port, like the JAX package compiled without its
rewrites, rounds the product and the sum apart: ROADMAP C10.)
"""
from __future__ import annotations

import dataclasses
import struct
import zlib
from typing import Optional

import numpy as np
import torch

from repro_torch.core.cameo import _device, _reconstruct
from repro_torch.store import codec as _codec

STAT_CODES = {"acf": 0, "pacf": 1}
STAT_NAMES = {v: k for k, v in STAT_CODES.items()}
_VCODEC_CODES = {"gorilla": 0, "chimp": 1}
_VCODEC_NAMES = {v: k for k, v in _VCODEC_CODES.items()}
_ENTROPY_CODES = {"none": 0, "zlib": 1, "zstd": 2}
_ENTROPY_NAMES = {v: k for k, v in _ENTROPY_CODES.items()}

_FLAG_LAST = 1
_FLAG_RESID = 2
_FLAG_META_V3 = 4      # header stores only sxx; moment rows derived at parse

# fixed header: t0 t1 n_kept | L kappa hv_len tv_len | stat vcodec entropy
# flags meta_codec | eps vmin vmax vsum vsumsq r1 r2 rx emax | idx_bits
# val_bits raw_nbytes payload_nbytes meta_nbytes
_HDR = struct.Struct("<QQI HHHH BBBBB 9d QQIII")


@dataclasses.dataclass(frozen=True)
class BlockMeta:
    """Decoded block header (everything except the payload streams)."""

    t0: int                 # global index of the first kept point (inclusive)
    t1: int                 # global index of the last kept point (inclusive)
    n_kept: int
    L: int
    kappa: int
    stat: str
    eps: float
    is_last: bool
    has_resid: bool
    vmin: float
    vmax: float
    vsum: float
    vsumsq: float
    r1: float               # sum of residuals  e = x - xr   (owned slice)
    r2: float               # sum of squared residuals
    rx: float               # sum of xr * e
    emax: float             # max |e|
    agg: np.ndarray         # [5, L] Eq. 7 sufficient stats of the owned slice
    head_vec: np.ndarray    # first min(L, owned) reconstruction values
    tail_vec: np.ndarray    # last  min(L, owned) reconstruction values
    idx_bits: int
    val_bits: int
    raw_nbytes: int
    payload_nbytes: int
    vcodec: str
    entropy: str

    @property
    def span(self) -> int:
        """Covered x-range length (inclusive of both kept borders)."""
        return self.t1 - self.t0 + 1

    @property
    def o0(self) -> int:
        return self.t0

    @property
    def o1(self) -> int:
        """Owned range end (exclusive): the shared border belongs to the
        next block, except for the final block."""
        return self.t1 + 1 if self.is_last else self.t1


# ---------------------------------------------------------------------------
# block planning — borders snapped to kept points
# ---------------------------------------------------------------------------

def plan_block_bounds(kept_idx: np.ndarray, block_len: int, L: int):
    """Block boundaries (kept indices, shared between neighbors).

    Boundaries start at ``kept_idx[0]`` and advance to the first kept index
    at least ``block_len`` away, so every owned span is ``>= block_len``
    (``block_len`` is clamped to ``>= L`` so cross-block lag pairs stay
    adjacent); a tail shorter than ``L`` merges into the previous block.
    """
    kept = np.asarray(kept_idx, np.int64)
    if kept.shape[0] < 2:
        raise ValueError("a stored series needs at least 2 kept points")
    block_len = max(int(block_len), int(L))
    bounds = [int(kept[0])]
    last = int(kept[-1])
    while bounds[-1] < last:
        j = int(np.searchsorted(kept, bounds[-1] + block_len, side="left"))
        nxt = int(kept[min(j, kept.shape[0] - 1)])
        if nxt >= last or last - nxt < L:
            nxt = last
        bounds.append(nxt)
    return bounds


def pack_meta_vectors(flat: np.ndarray, entropy: str = "auto"):
    """Losslessly compact float64 metadata vectors -> (payload, codec).

    xor-delta over the uint64 bit patterns (smooth aggregate vectors leave
    mostly-zero high bytes), then a byte-plane shuffle (all 1st bytes, all
    2nd bytes, ...) so the zero runs are contiguous for the entropy wrap.
    Bit-exact for every IEEE value incl. NaN payloads and infinities.
    """
    u = np.ascontiguousarray(np.asarray(flat, np.float64)).view(np.uint64)
    if u.shape[0] == 0:
        return b"", "none"
    d = np.empty_like(u)
    d[0] = u[0]
    d[1:] = u[1:] ^ u[:-1]
    planes = np.ascontiguousarray(d.view(np.uint8).reshape(-1, 8).T)
    return _codec.entropy_wrap(planes.tobytes(), entropy)


def unpack_meta_vectors(payload: bytes, count: int,
                        codec: str) -> np.ndarray:
    """Bit-exact inverse of :func:`pack_meta_vectors` -> float64 [count]."""
    if count == 0:
        return np.empty(0, np.float64)
    raw = _codec.entropy_unwrap(payload, codec)
    d = np.ascontiguousarray(
        np.frombuffer(raw, np.uint8).reshape(8, count).T).view(np.uint64)
    return np.bitwise_xor.accumulate(d.ravel()).view(np.float64)


def _slice_aggregates(v: np.ndarray, L: int) -> np.ndarray:
    """Eq. 7 sufficient statistics of a value slice, numpy form, [5, L]."""
    v = np.asarray(v, np.float64)
    m = v.shape[0]
    cs = np.concatenate([[0.0], np.cumsum(v)])
    cs2 = np.concatenate([[0.0], np.cumsum(v * v)])
    agg = np.zeros((5, L))
    for j in range(L):
        l = j + 1
        if m <= l:
            continue
        agg[0, j] = cs[m - l]                 # sx:  head sum
        agg[1, j] = cs[m] - cs[l]             # sxl: tail sum
        agg[2, j] = cs2[m - l]                # sx2
        agg[3, j] = cs2[m] - cs2[l]           # sxl2
        agg[4, j] = float(np.dot(v[:m - l], v[l:]))   # sxx
    return agg


def _slice_lag_products(v: np.ndarray, L: int) -> np.ndarray:
    """Row 4 of :func:`_slice_aggregates` alone (the only stored row in v3)."""
    v = np.asarray(v, np.float64)
    m = v.shape[0]
    return np.array([float(np.dot(v[:m - l], v[l:])) if m > l else 0.0
                     for l in range(1, L + 1)])


def derive_aggregate_rows(sxx: np.ndarray, hv: np.ndarray, tv: np.ndarray,
                          vsum: float, vsumsq: float, m: int) -> np.ndarray:
    """Reassemble the ``[5, L]`` Eq. 7 table from the v3 header fields.

    ``m`` is the owned-slice length.  For every defined lag (``l < m``) the
    moment rows follow from the scalar totals and the edge vectors::

        sx(l)   = vsum   - sum(last  l values)     (tail cumsum of ``tv``)
        sxl(l)  = vsum   - sum(first l values)     (head cumsum of ``hv``)
        sx2(l)  = vsumsq - sum(last  l squares)
        sxl2(l) = vsumsq - sum(first l squares)

    Defined lags satisfy ``l <= min(L, m-1) <= len(hv) == len(tv)``, so the
    cumulative sums always cover them.  Exact-on-derivation: deterministic,
    equal to the v2 stored rows up to summation-order rounding; ``sxx``
    passes through untouched (bit-exact).
    """
    L = sxx.shape[0]
    agg = np.zeros((5, L))
    # the stored sxx is already zero on undefined lags (writer masks m <= l)
    agg[4] = sxx
    if m <= 1 or hv.shape[0] == 0:
        return agg
    l = np.arange(1, L + 1)
    valid = l < m
    k = np.clip(l - 1, 0, tv.shape[0] - 1)
    kh = np.clip(l - 1, 0, hv.shape[0] - 1)
    cst = np.cumsum(tv[::-1])
    cst2 = np.cumsum((tv * tv)[::-1])
    csh = np.cumsum(hv)
    csh2 = np.cumsum(hv * hv)
    agg[0] = np.where(valid, vsum - cst[k], 0.0)
    agg[1] = np.where(valid, vsum - csh[kh], 0.0)
    agg[2] = np.where(valid, vsumsq - cst2[k], 0.0)
    agg[3] = np.where(valid, vsumsq - csh2[kh], 0.0)
    return agg


# ---------------------------------------------------------------------------
# encode / decode
# ---------------------------------------------------------------------------

def build_block(kept_idx, kept_vals, *, t0: int, t1: int, is_last: bool,
                owned_xr: np.ndarray, L: int, kappa: int, stat: str,
                eps: float, resid: Optional[np.ndarray] = None,
                resid_moments: Optional[tuple] = None,
                value_codec: str = "gorilla", entropy: str = "auto",
                meta_version: int = 3):
    """Encode one block -> ``(body, info)``.

    ``kept_idx``/``kept_vals`` are the kept points in ``[t0, t1]`` (global
    indices, both borders included); ``owned_xr`` is the reconstruction over
    the owned range and ``resid`` the residual ``x - xr`` over the same
    range when the original was available.  ``resid_moments`` is the
    alternative when the original is *not* available but its Plato moments
    are: a ``(r1, r2, rx, emax)`` tuple stored verbatim — the compaction
    rewriter merges blocks whose owned ranges exactly partition the merged
    range, so the moments of the merged block are the sums (max for
    ``emax``) of the parts' stored moments.  ``info`` carries
    ``payload_nbytes`` (the codec-only stream size), ``meta_nbytes`` (the
    compacted aggregate/edge metadata) and ``meta_raw_nbytes`` (what the
    stored metadata vectors would cost uncompacted) — header metadata is
    accounted separately from the payload because for large ``L`` on short
    blocks it can dominate, and the two CR flavors should stay tellable
    apart.  ``meta_version=3`` (default) stores only the ``sxx`` row and
    derives the four moment rows at parse; ``meta_version=2`` writes the
    legacy all-five-rows layout (kept writable for compatibility tests)."""
    if meta_version not in (2, 3):
        raise ValueError(f"unknown block meta version {meta_version}")
    kept_idx = np.asarray(kept_idx, np.int64)
    kept_vals = np.asarray(kept_vals, np.float64)
    owned_xr = np.asarray(owned_xr, np.float64)
    local_idx = kept_idx - t0
    payload, pinfo = _codec.encode_series_payload(
        local_idx, kept_vals, value_codec=value_codec, entropy=entropy)

    hv = owned_xr[:min(L, owned_xr.shape[0])]
    tv = owned_xr[-min(L, owned_xr.shape[0]):]
    if meta_version == 3:
        agg_stored = _slice_lag_products(owned_xr, L)
    else:
        agg_stored = _slice_aggregates(owned_xr, L).ravel()

    flags = (_FLAG_LAST if is_last else 0)
    if meta_version == 3:
        flags |= _FLAG_META_V3
    if resid is not None:
        resid = np.asarray(resid, np.float64)
        flags |= _FLAG_RESID
        r1, r2 = float(resid.sum()), float(np.dot(resid, resid))
        rx = float(np.dot(owned_xr, resid))
        emax = float(np.max(np.abs(resid))) if resid.size else 0.0
    elif resid_moments is not None:
        flags |= _FLAG_RESID
        r1, r2, rx, emax = (float(v) for v in resid_moments)
    else:
        r1 = r2 = rx = emax = 0.0

    meta_flat = np.concatenate([agg_stored, hv, tv])
    meta_payload, meta_codec = pack_meta_vectors(meta_flat, entropy)

    header = _HDR.pack(
        t0, t1, int(kept_idx.shape[0]),
        L, kappa, hv.shape[0], tv.shape[0],
        STAT_CODES[stat], _VCODEC_CODES[value_codec],
        _ENTROPY_CODES[pinfo["entropy"]], flags,
        _ENTROPY_CODES[meta_codec],
        float(eps), float(owned_xr.min()), float(owned_xr.max()),
        float(owned_xr.sum()), float(np.dot(owned_xr, owned_xr)),
        r1, r2, rx, emax,
        pinfo["idx_bits"], pinfo["val_bits"],
        pinfo["raw_nbytes"], pinfo["nbytes"], len(meta_payload))
    body = header + meta_payload + payload
    info = dict(payload_nbytes=len(payload),
                meta_nbytes=len(meta_payload),
                meta_raw_nbytes=int(meta_flat.nbytes))
    return body + struct.pack("<I", zlib.crc32(body)), info


def parse_block(body: bytes, *, with_payload: bool = True):
    """Decode a block body -> ``(BlockMeta, kept_idx_global, kept_vals)``.

    ``with_payload=False`` skips the bitstream decode (header-only reads for
    pushdown queries) and returns ``(meta, None, None)``.
    """
    crc_stored, = struct.unpack("<I", body[-4:])
    body = body[:-4]
    if zlib.crc32(body) != crc_stored:
        raise IOError("block corrupt: crc mismatch")
    (t0, t1, n_kept, L, kappa, hv_len, tv_len, stat_c, vcodec_c, ent_c,
     flags, meta_c, eps, vmin, vmax, vsum, vsumsq, r1, r2, rx, emax,
     idx_bits, val_bits, raw_nbytes, payload_nbytes,
     meta_nbytes) = _HDR.unpack(body[:_HDR.size])
    off = _HDR.size
    is_v3 = bool(flags & _FLAG_META_V3)
    agg_rows = 1 if is_v3 else 5
    meta_count = agg_rows * L + hv_len + tv_len
    meta_flat = unpack_meta_vectors(body[off:off + meta_nbytes], meta_count,
                                    _ENTROPY_NAMES[meta_c])
    off += meta_nbytes
    hv = meta_flat[agg_rows * L:agg_rows * L + hv_len]
    tv = meta_flat[agg_rows * L + hv_len:]
    if is_v3:
        owned = (t1 + 1 if flags & _FLAG_LAST else t1) - t0
        agg = derive_aggregate_rows(meta_flat[:L], hv, tv, vsum, vsumsq,
                                    owned)
    else:
        agg = meta_flat[:5 * L].reshape(5, L)
    meta = BlockMeta(
        t0=t0, t1=t1, n_kept=n_kept, L=L, kappa=kappa,
        stat=STAT_NAMES[stat_c], eps=eps,
        is_last=bool(flags & _FLAG_LAST), has_resid=bool(flags & _FLAG_RESID),
        vmin=vmin, vmax=vmax, vsum=vsum, vsumsq=vsumsq,
        r1=r1, r2=r2, rx=rx, emax=emax,
        agg=agg, head_vec=hv, tail_vec=tv,
        idx_bits=idx_bits, val_bits=val_bits, raw_nbytes=raw_nbytes,
        payload_nbytes=payload_nbytes,
        vcodec=_VCODEC_NAMES[vcodec_c], entropy=_ENTROPY_NAMES[ent_c])
    if not with_payload:
        return meta, None, None
    payload = body[off:off + payload_nbytes]
    local_idx, vals = _codec.decode_series_payload(
        payload, n_kept, meta.entropy, meta.vcodec)
    return meta, local_idx + t0, vals


# ---------------------------------------------------------------------------
# multivariate blocks (store format v4): one shared index stream per block,
# per-column value streams + per-column pushdown metadata
# ---------------------------------------------------------------------------

# fixed mvar header: t0 t1 n_kept C | L kappa hv_len tv_len | stat vcodec
# idx_ent vals_ent flags meta_codec | eps | idx_bits val_bits | raw_nbytes
# idx_nbytes vals_nbytes meta_nbytes
_MHDR = struct.Struct("<QQIH HHHH BBBBBB d QQ IIII")


@dataclasses.dataclass(frozen=True)
class MBlockMeta:
    """Decoded multivariate block header.

    The per-column fields are arrays over the ``channels`` axis; ``col(c)``
    projects one column into an ordinary :class:`BlockMeta` (the Eq. 7
    moment rows derived exactly as for v3 univariate headers), so the
    pushdown machinery in ``store/query.py`` serves any single column
    without knowing the block is multivariate.
    """

    t0: int
    t1: int
    n_kept: int
    channels: int
    L: int
    kappa: int
    stat: str
    eps: float
    is_last: bool
    has_resid: bool
    vmin: np.ndarray        # [C]
    vmax: np.ndarray        # [C]
    vsum: np.ndarray        # [C]
    vsumsq: np.ndarray      # [C]
    r1: np.ndarray          # [C]
    r2: np.ndarray          # [C]
    rx: np.ndarray          # [C]
    emax: np.ndarray        # [C]
    sxx: np.ndarray         # [C, L] Eq. 7 lagged products per column
    head_vec: np.ndarray    # [C, min(L, owned)]
    tail_vec: np.ndarray    # [C, min(L, owned)]
    idx_bits: int
    val_bits: int
    raw_nbytes: int
    payload_nbytes: int
    vcodec: str
    entropy: str

    @property
    def span(self) -> int:
        return self.t1 - self.t0 + 1

    @property
    def o0(self) -> int:
        return self.t0

    @property
    def o1(self) -> int:
        return self.t1 + 1 if self.is_last else self.t1

    def col(self, c: int) -> BlockMeta:
        """Single-column view: a v3-equivalent univariate header whose
        moment rows are derived from this block's per-column metadata."""
        agg = derive_aggregate_rows(
            self.sxx[c], self.head_vec[c], self.tail_vec[c],
            float(self.vsum[c]), float(self.vsumsq[c]), self.o1 - self.t0)
        return BlockMeta(
            t0=self.t0, t1=self.t1, n_kept=self.n_kept, L=self.L,
            kappa=self.kappa, stat=self.stat, eps=self.eps,
            is_last=self.is_last, has_resid=self.has_resid,
            vmin=float(self.vmin[c]), vmax=float(self.vmax[c]),
            vsum=float(self.vsum[c]), vsumsq=float(self.vsumsq[c]),
            r1=float(self.r1[c]), r2=float(self.r2[c]),
            rx=float(self.rx[c]), emax=float(self.emax[c]),
            agg=agg, head_vec=self.head_vec[c], tail_vec=self.tail_vec[c],
            idx_bits=self.idx_bits, val_bits=self.val_bits,
            raw_nbytes=self.raw_nbytes, payload_nbytes=self.payload_nbytes,
            vcodec=self.vcodec, entropy=self.entropy)


def build_mblock(kept_idx, kept_vals, *, t0: int, t1: int, is_last: bool,
                 owned_xr: np.ndarray, L: int, kappa: int, stat: str,
                 eps: float, resid: Optional[np.ndarray] = None,
                 value_codec: str = "gorilla", entropy: str = "auto"):
    """Encode one multivariate block -> ``(body, info)``.

    ``kept_vals`` is ``[k, C]`` (per-column values on the shared kept
    index), ``owned_xr`` ``[owned, C]`` the per-column reconstructions over
    the owned range, ``resid`` optionally ``[owned, C]``.  The index stream
    is encoded **once** — the Sprintz-style shared-timestamp saving — while
    values and the Eq. 7 pushdown metadata stay per-column, so single-column
    reads and per-column error bounds cost nothing extra.
    """
    kept_idx = np.asarray(kept_idx, np.int64)
    kept_vals = np.asarray(kept_vals, np.float64)
    owned_xr = np.asarray(owned_xr, np.float64)
    if kept_vals.ndim != 2 or owned_xr.ndim != 2:
        raise ValueError("multivariate blocks want [k, C] values and "
                         "[owned, C] reconstructions")
    C = kept_vals.shape[1]
    local_idx = kept_idx - t0

    idx_bytes = _codec.encode_indices(local_idx)
    idx_payload, idx_ent = _codec.entropy_wrap(idx_bytes, entropy)
    streams = [_codec.VALUE_ENCODERS[value_codec](
        np.ascontiguousarray(kept_vals[:, c])) for c in range(C)]
    vals_raw = b"".join(len(s).to_bytes(4, "little") + s for s in streams)
    vals_payload, vals_ent = _codec.entropy_wrap(vals_raw, entropy)
    val_bits = sum(_codec.VALUE_BIT_COUNTERS[value_codec](
        np.ascontiguousarray(kept_vals[:, c])) for c in range(C))

    h = min(L, owned_xr.shape[0])
    hv = owned_xr[:h].T                      # [C, h]
    tv = owned_xr[owned_xr.shape[0] - h:].T  # [C, h]
    sxx = np.stack([_slice_lag_products(owned_xr[:, c], L)
                    for c in range(C)])      # [C, L]
    flags = _FLAG_LAST if is_last else 0
    if resid is not None:
        resid = np.asarray(resid, np.float64)
        flags |= _FLAG_RESID
        r1 = resid.sum(axis=0)
        r2 = np.einsum("nc,nc->c", resid, resid)
        rx = np.einsum("nc,nc->c", owned_xr, resid)
        emax = (np.abs(resid).max(axis=0) if resid.shape[0]
                else np.zeros(C))
    else:
        r1 = r2 = rx = emax = np.zeros(C)
    scalars = np.stack([
        owned_xr.min(axis=0), owned_xr.max(axis=0),
        owned_xr.sum(axis=0), np.einsum("nc,nc->c", owned_xr, owned_xr),
        r1, r2, rx, emax])                   # [8, C]

    meta_flat = np.concatenate([scalars.ravel(), sxx.ravel(),
                                hv.ravel(), tv.ravel()])
    meta_payload, meta_codec = pack_meta_vectors(meta_flat, entropy)

    raw_nbytes = len(idx_bytes) + len(vals_raw)
    header = _MHDR.pack(
        t0, t1, int(kept_idx.shape[0]), C,
        L, kappa, h, h,
        STAT_CODES[stat], _VCODEC_CODES[value_codec],
        _ENTROPY_CODES[idx_ent], _ENTROPY_CODES[vals_ent], flags,
        _ENTROPY_CODES[meta_codec],
        float(eps),
        _codec.index_stream_bits(local_idx), val_bits,
        raw_nbytes, len(idx_payload), len(vals_payload), len(meta_payload))
    body = header + meta_payload + idx_payload + vals_payload
    info = dict(payload_nbytes=len(idx_payload) + len(vals_payload),
                meta_nbytes=len(meta_payload),
                meta_raw_nbytes=int(meta_flat.nbytes))
    return body + struct.pack("<I", zlib.crc32(body)), info


def parse_mblock(body: bytes, *, with_payload: bool = True):
    """Decode a multivariate block body -> ``(MBlockMeta, kept_idx_global,
    kept_vals [k, C])``; ``with_payload=False`` skips the bitstreams."""
    crc_stored, = struct.unpack("<I", body[-4:])
    body = body[:-4]
    if zlib.crc32(body) != crc_stored:
        raise IOError("block corrupt: crc mismatch")
    (t0, t1, n_kept, C, L, kappa, hv_len, tv_len, stat_c, vcodec_c,
     idx_ent_c, vals_ent_c, flags, meta_c, eps, idx_bits, val_bits,
     raw_nbytes, idx_nbytes, vals_nbytes,
     meta_nbytes) = _MHDR.unpack(body[:_MHDR.size])
    off = _MHDR.size
    meta_count = 8 * C + C * L + C * hv_len + C * tv_len
    meta_flat = unpack_meta_vectors(body[off:off + meta_nbytes], meta_count,
                                    _ENTROPY_NAMES[meta_c])
    off += meta_nbytes
    scalars = meta_flat[:8 * C].reshape(8, C)
    p = 8 * C
    sxx = meta_flat[p:p + C * L].reshape(C, L)
    p += C * L
    hv = meta_flat[p:p + C * hv_len].reshape(C, hv_len)
    p += C * hv_len
    tv = meta_flat[p:p + C * tv_len].reshape(C, tv_len)
    meta = MBlockMeta(
        t0=t0, t1=t1, n_kept=n_kept, channels=C, L=L, kappa=kappa,
        stat=STAT_NAMES[stat_c], eps=eps,
        is_last=bool(flags & _FLAG_LAST),
        has_resid=bool(flags & _FLAG_RESID),
        vmin=scalars[0], vmax=scalars[1], vsum=scalars[2],
        vsumsq=scalars[3], r1=scalars[4], r2=scalars[5], rx=scalars[6],
        emax=scalars[7], sxx=sxx, head_vec=hv, tail_vec=tv,
        idx_bits=idx_bits, val_bits=val_bits, raw_nbytes=raw_nbytes,
        payload_nbytes=idx_nbytes + vals_nbytes,
        vcodec=_VCODEC_NAMES[vcodec_c],
        entropy=_ENTROPY_NAMES[vals_ent_c])
    if not with_payload:
        return meta, None, None
    idx_raw = _codec.entropy_unwrap(body[off:off + idx_nbytes],
                                    _ENTROPY_NAMES[idx_ent_c])
    local_idx = _codec.decode_indices(idx_raw, n_kept)
    off += idx_nbytes
    vals_raw = _codec.entropy_unwrap(body[off:off + vals_nbytes],
                                     _ENTROPY_NAMES[vals_ent_c])
    vals = np.empty((n_kept, C), np.float64)
    pos = 0
    for c in range(C):
        slen = int.from_bytes(vals_raw[pos:pos + 4], "little")
        pos += 4
        vals[:, c] = _codec.VALUE_DECODERS[meta.vcodec](
            vals_raw[pos:pos + slen], n_kept)
        pos += slen
    return meta, local_idx + t0, vals


# ---------------------------------------------------------------------------
# bit-exact block reconstruction
# ---------------------------------------------------------------------------

def reconstruct_block(local_idx: np.ndarray, vals: np.ndarray, span: int,
                      dtype: str = "float64", device="cuda") -> np.ndarray:
    """Reconstruction over a block's covered range from its kept points.

    Runs the compressor's own interpolation (``_reconstruct``) on
    ``device`` over the block's span; the result is bit-identical to the
    matching slice of ``CompressResult.xr``.
    """
    dev = _device(device)
    tdt = getattr(torch, np.dtype(dtype).name)
    idx = torch.as_tensor(np.asarray(local_idx, np.int64)).to(dev)
    buf = torch.zeros(span, dtype=tdt, device=dev)
    buf[idx] = torch.as_tensor(np.asarray(vals, np.dtype(dtype))).to(dev)
    alive = torch.zeros(span, dtype=torch.bool, device=dev)
    alive[idx] = True
    return _reconstruct(buf, alive).cpu().numpy()
