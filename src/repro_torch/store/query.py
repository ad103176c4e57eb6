"""Pushdown aggregates over compressed windows (Plato-style, PAPERS.md).

Aggregate queries over an arbitrary time window ``[a, b)`` are answered
from **block metadata** wherever the window fully covers a block's owned
range, falling back to a partial decode *only at the (at most two)
window-edge blocks*.  Every answer comes back as ``(value, bound)`` with a
deterministic error bound:

* ``sum`` / ``mean`` / ``var`` — when the series was ingested with its
  original (``append_series(..., x=...)``), interior blocks contribute
  their stored signed residual moments, so their part of the answer equals
  the **original** series' aggregate exactly; only the decoded edge slices
  contribute uncertainty, bounded by ``n_edge * max|residual|`` (and the
  matched second-moment form for ``var``).  Without residual metadata the
  same machinery answers exactly over the *reconstruction* (bounds then
  cover float rounding only).
* ``acf`` — the window ACF of the reconstruction, assembled exactly from
  the per-block Eq. 7 sufficient statistics, the stored first/last-``L``
  edge vectors (cross-block lag products), and decoded edge slices.  Its
  bound covers the floating-point reassembly error (computed from aggregate
  magnitudes, not measured), i.e. the answer is exact-on-reconstruction up
  to that bound.  The compression-time guarantee ``deviation <= eps``
  relating the reconstruction's *global* ACF to the original's is recorded
  in the series catalog and reported alongside.

Every bound is computed from stored metadata + deterministic float-slop
terms — never from comparing against a full decode.

The only decodes this module ever triggers are the window-edge blocks, and
those ride the store's decoded-block LRU (``CameoStore(cache_bytes=...)``)
— a repeated window query is answered from cached headers + cached edge
reconstructions without touching the bitstreams, which is the steady-state
(warm) pushdown latency the store benchmark reports.
"""
from __future__ import annotations

from time import perf_counter as _perf_counter

import numpy as np

from repro_torch.obs import OBS

_U = 2.0 ** -52          # one ulp at 1.0
_SLOP = 64.0             # growth allowance on accumulated rounding


def _segments(store, sid: str, a: int, b: int):
    """Ordered window cover: ``(kind, meta, lo, hi, vals)`` per block, where
    ``kind == "meta"`` means the window fully covers the block's owned range
    (metadata only) and ``"edge"`` means a partial decode of ``[lo, hi)``.
    Only the overlapping blocks' headers are touched (cached in the store)."""
    segs = []
    n_meta = n_edge = 0
    for bi in store._overlapping(sid, a, b):
        m = store.block_meta(sid, bi)
        lo, hi = max(a, m.o0), min(b, m.o1)
        if lo == m.o0 and hi == m.o1:
            segs.append(("meta", m, lo, hi, None))
            n_meta += 1
        else:
            segs.append(
                ("edge", m, lo, hi,
                 np.asarray(store.read_window(sid, lo, hi), np.float64)))
            n_edge += 1
    if OBS.enabled:
        # pushdown-vs-decode decision counters, per block and per call
        OBS.inc("query.segments_meta", n_meta)
        OBS.inc("query.segments_edge", n_edge)
        OBS.inc("query.meta_only" if n_edge == 0 else
                "query.with_edge_decode")
    return segs


def _check_window(store, sid, a, b):
    n = store.series_meta(sid)["n"]
    a, b = int(a), int(b)
    if not (0 <= a < b <= n):
        raise ValueError(f"window [{a}, {b}) outside series [0, {n})")
    return a, b


def _moments(segs):
    """(S, bS, Q, bQ, scale): first/second moments of the *original* window
    (when residual metadata exists; else the reconstruction) and their
    deterministic bounds, plus a value-scale proxy for float slop."""
    S = bS = Q = bQ = 0.0
    scale = 0.0
    for kind, m, lo, hi, vals in segs:
        amax = max(abs(m.vmin), abs(m.vmax)) + m.emax
        scale = max(scale, amax)
        if kind == "meta":
            S += m.vsum + m.r1
            Q += m.vsumsq + 2.0 * m.rx + m.r2
        else:
            ne = hi - lo
            S += float(vals.sum())
            Q += float(np.dot(vals, vals))
            bS += ne * m.emax
            bQ += ne * (2.0 * amax * m.emax + m.emax * m.emax)
    return S, bS, Q, bQ, scale


def window_sum(store, sid: str, a: int, b: int):
    a, b = _check_window(store, sid, a, b)
    segs = _segments(store, sid, a, b)
    S, bS, _, _, scale = _moments(segs)
    return S, bS + _U * _SLOP * (b - a) * scale


def window_mean(store, sid: str, a: int, b: int):
    s, bs = window_sum(store, sid, a, b)
    nw = b - a
    return s / nw, bs / nw


def window_var(store, sid: str, a: int, b: int):
    """Population variance of the window, interval-propagated through
    ``Q/n - (S/n)^2``."""
    a, b = _check_window(store, sid, a, b)
    segs = _segments(store, sid, a, b)
    S, bS, Q, bQ, scale = _moments(segs)
    nw = b - a
    slop = _U * _SLOP * nw * scale
    bS, bQ = bS + slop, bQ + slop * scale
    mean = S / nw
    bmean = bS / nw
    var = Q / nw - mean * mean
    bound = bQ / nw + 2.0 * abs(mean) * bmean + bmean * bmean
    return var, bound


def _window_head_tail(segs, L: int):
    """First/last ``min(L, nw)`` reconstruction values of the window, from
    stored edge vectors (meta segments own >= L values) or decoded slices."""
    head_parts, got = [], 0
    for kind, m, lo, hi, vals in segs:
        src = vals if kind == "edge" else m.head_vec
        head_parts.append(src[:L - got])
        got += head_parts[-1].shape[0]
        if got >= L:
            break
    tail_parts, got = [], 0
    for kind, m, lo, hi, vals in reversed(segs):
        src = vals if kind == "edge" else m.tail_vec
        take = src[max(0, src.shape[0] - (L - got)):]
        tail_parts.append(take)
        got += take.shape[0]
        if got >= L:
            break
    return (np.concatenate(head_parts),
            np.concatenate(list(reversed(tail_parts))))


def _lag_products(v: np.ndarray, L: int) -> np.ndarray:
    out = np.zeros(L)
    m = v.shape[0]
    for j in range(min(L, m - 1)):
        out[j] = float(np.dot(v[:m - j - 1], v[j + 1:]))
    return out


def _cross_lag(tail_a: np.ndarray, head_b: np.ndarray, L: int) -> np.ndarray:
    """Lag products for pairs straddling two consecutive segments:
    ``out[l-1] = sum_j tail_a[-j] * head_b[l-j]`` over valid ``j``."""
    out = np.zeros(L)
    la, lb = tail_a.shape[0], head_b.shape[0]
    for j in range(L):
        l = j + 1
        jhi = min(l, la)          # how far back into A pairs can start
        jlo = max(1, l - lb + 1)  # partner must exist within B's head
        if jhi < jlo:
            continue
        out[j] = float(np.dot(tail_a[la - jhi:la - jlo + 1],
                              head_b[l - jhi:l - jlo + 1]))
    return out


def window_acf(store, sid: str, a: int, b: int):
    """Window ACF (Eq. 2) of the reconstruction over ``[a, b)`` with a
    deterministic float-reassembly bound; see the module docstring for the
    guarantee structure.  Requires ``b - a > lags``."""
    a, b = _check_window(store, sid, a, b)
    entry = store.series_meta(sid)
    L = entry["lags"]
    nw = b - a
    if nw <= L + 1:
        raise ValueError(f"window of {nw} points too short for {L} lags")
    segs = _segments(store, sid, a, b)

    total = total2 = 0.0
    sxx = np.zeros(L)
    prev_tail = None
    for kind, m, lo, hi, vals in segs:
        if kind == "meta":
            total += m.vsum
            total2 += m.vsumsq
            sxx += m.agg[4]
            head, tail = m.head_vec, m.tail_vec
        else:
            total += float(vals.sum())
            total2 += float(np.dot(vals, vals))
            sxx += _lag_products(vals, L)
            head, tail = vals[:L], vals[-L:]
        if prev_tail is not None:
            sxx += _cross_lag(prev_tail, head, L)
        prev_tail = tail

    whead, wtail = _window_head_tail(segs, L)
    l = np.arange(1, L + 1, dtype=np.float64)
    csh = np.cumsum(whead)
    csh2 = np.cumsum(whead * whead)
    cst = np.cumsum(wtail[::-1])          # cst[j] = sum of last j+1 values
    cst2 = np.cumsum((wtail * wtail)[::-1])
    sx = total - cst[:L]
    sxl = total - csh[:L]
    sx2 = total2 - cst2[:L]
    sxl2 = total2 - csh2[:L]

    m_l = nw - l
    num = m_l * sxx - sx * sxl
    vh = m_l * sx2 - sx * sx
    vt = m_l * sxl2 - sxl * sxl
    denom2 = vh * vt
    tiny = 1e-30
    denom = np.sqrt(np.maximum(denom2, tiny))
    ok = denom2 > tiny
    acf = np.where(ok, num / denom, 0.0)

    # float-reassembly budget from aggregate magnitudes (Cauchy-Schwarz:
    # |sxx| <= Q, |sx| <= sqrt(nw*Q)), never from a reference decode.
    C = _U * 4096.0
    Q = max(total2, tiny)
    err_lin = C * Q * (m_l + nw)          # |m*agg| + |sx*sxl| style products
    err_denom = (err_lin * np.abs(vt) + np.abs(vh) * err_lin) / (2.0 * denom)
    bound = np.where(
        ok, (err_lin + np.abs(acf) * err_denom) / denom + C, 2.0)
    return acf, bound


AGGREGATES = {
    "sum": window_sum,
    "mean": window_mean,
    "var": window_var,
    "acf": window_acf,
}


class ColumnView:
    """Single-column façade over a multivariate series.

    Duck-types the four store entry points the pushdown machinery touches
    (``series_meta`` / ``_overlapping`` / ``block_meta`` / ``read_window``),
    projecting every multivariate block header onto one column
    (``MBlockMeta.col``) and every decode onto one value stream — so the
    aggregate functions above serve per-column answers *unchanged*, with
    the same deterministic bound structure they give univariate series.
    """

    def __init__(self, store, sid: str, col: int):
        C = store.channels(sid)
        if not (0 <= int(col) < C):
            raise ValueError(f"column {col} outside [0, {C}) for {sid!r}")
        self._store = store
        self._sid = sid
        self.col = int(col)

    def series_meta(self, sid: str) -> dict:
        return self._store.series_meta(self._sid)

    def _overlapping(self, sid: str, a: int, b: int):
        return self._store._overlapping(self._sid, a, b)

    def block_meta(self, sid: str, bi: int):
        meta = self._store.block_meta(self._sid, bi)
        return meta.col(self.col) if hasattr(meta, "col") else meta

    def read_window(self, sid: str, a: int, b: int):
        return self._store.read_window(self._sid, a, b, col=self.col)


def query(store, sid: str, kind: str, a=None, b=None, col=None):
    """Dispatch a pushdown aggregate; ``a``/``b`` default to the full
    series.  Returns ``(value, bound)``.

    For a multivariate series, ``col`` selects one column; with
    ``col=None`` the aggregate runs across **all** columns off a single
    header pass (interior block headers are parsed once and cached, every
    column projects from the same ``MBlockMeta``), returning stacked
    ``(values [C, ...], bounds [C, ...])`` arrays.
    """
    if not OBS.enabled:
        return _query(store, sid, kind, a, b, col)
    t0 = _perf_counter()
    out = _query(store, sid, kind, a, b, col)
    OBS.observe("query.seconds", _perf_counter() - t0)
    OBS.inc("query.count")
    OBS.inc(f"query.kind.{kind}")
    # realized bound width: the widest bound the answer shipped with
    OBS.observe("query.bound_width", float(np.max(out[1])))
    return out


def _query(store, sid, kind, a, b, col):
    if kind not in AGGREGATES:
        raise ValueError(f"unknown aggregate {kind!r}; have "
                         f"{sorted(AGGREGATES)}")
    entry = store.series_meta(sid)
    n = entry["n"]
    a = 0 if a is None else a
    b = n if b is None else b
    C = int(entry.get("channels", 1))
    if C == 1:
        if col not in (None, 0):
            raise ValueError(f"column {col} outside [0, 1) for "
                             f"univariate series {sid!r}")
        return AGGREGATES[kind](store, sid, a, b)
    if col is not None:
        return AGGREGATES[kind](ColumnView(store, sid, col), sid, a, b)
    vals, bounds = zip(*(AGGREGATES[kind](ColumnView(store, sid, c),
                                          sid, a, b) for c in range(C)))
    return np.asarray(vals), np.asarray(bounds)
