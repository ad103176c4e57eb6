"""Incremental maintenance of the ACF aggregates (paper Eqs. 8-11; port of
``repro/core/aggregates.py``).

* ``apply_delta_dense`` — exact update from a dense delta vector (the
  rounds mode: one O(nL) update per round, including the cross-lag
  bilinear term across all of the round's segments).
* ``apply_delta_window`` — exact update from a delta confined to a
  window of ``W`` points (the sequential mode, Eq. 9).
* the alive-neighbor geometry: ``alive_neighbors``,
  ``neighbors_after_removal``, ``interpolate_at`` and the segment deltas.

The interpolation arithmetic follows the reference op for op, so the
reconstruction ``xr`` that the compressor carries is exactly the one
``core.cameo._reconstruct`` rebuilds from the kept points.

All functions operate on the target series ``y`` (the raw series for
``kappa == 1``, the tumbling-window aggregate series for Def. 2).  The
rounds mode's (``apply_delta_dense``, the neighbor geometry and the
segment deltas) also take a leading lane axis, a batch of series
``[B, n]`` with per-lane indices, tables ``[B, 5, L]`` and valid lengths
``[B]``; each lane is computed exactly as it is alone.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.acf import Aggregates
from repro_torch.kernels import ops as _ops
from repro_torch.kernels import ref as _ref
from repro_torch.kernels.ref import agg_rows, gather_clamped, lane_col, take


# ---------------------------------------------------------------------------
# Dense exact update (rounds mode)
# ---------------------------------------------------------------------------

def _dense_moment_deltas(y_old, delta, ny, L, backend):
    l = torch.arange(1, L + 1, device=y_old.device)
    e = delta * (2.0 * y_old + delta)
    # one launch for both rows: on the card their chains run side by side
    cd, ce = _ops.prefix_sum(torch.stack([delta, e], dim=-2),
                             backend).unbind(-2)
    dtot, etot = cd[..., -1:], ce[..., -1:]
    head = lane_col(ny, delta) - 1 - l
    dsx = gather_clamped(cd, head)
    dsx2 = gather_clamped(ce, head)
    dsxl = dtot - gather_clamped(cd, l - 1)
    dsxl2 = etot - gather_clamped(ce, l - 1)
    return dsx, dsxl, dsx2, dsxl2


def _with_deltas(agg, dtable):
    if isinstance(agg, torch.Tensor):
        return agg + dtable
    return Aggregates(*(agg[i] + dtable[..., i, :] for i in range(5)))


def apply_delta_dense(agg, y_old: torch.Tensor, delta: torch.Tensor,
                      ny=None, backend: str = "auto"):
    """Exact aggregate update for an arbitrary dense delta vector.

    ``y_old`` is the reconstruction before the update.  The four moment
    sums cost O(ny + L) through cumulative sums (``ops.prefix_sum``); the
    bilinear ``sxx`` term is one masked term a (point, lag) summed in the
    JAX reference's CPU order (``ops.dense_sxx``), on every device.

    ``agg`` may be the ``Aggregates`` tuple or the packed ``[5, L]`` table
    (the rounds-mode carry); the update comes back in the same form.
    ``ny`` (int or 0-d tensor) gives the valid length when ``y_old`` and
    ``delta`` live in a zero-padded bucket; both must be zero beyond it.
    With lanes: ``y_old``/``delta [B, nyb]``, ``agg [B, 5, L]``, ``ny
    [B]``; each lane's update has the bits of the lane alone.
    """
    nyb = y_old.shape[-1]
    if ny is None:
        ny = nyb
    L = agg_rows(agg)[0].shape[-1]
    dsx, dsxl, dsx2, dsxl2 = _dense_moment_deltas(y_old, delta, ny, L,
                                                  backend)
    # new*new - old*old expanded over lag shifts:
    #   d_t*y_{t+l} + y_t*d_{t+l} + d_t*d_{t+l} = d_t*(y+d)_{t+l} + y_t*d_{t+l}
    # one masked term a pair, summed over t in the JAX reference's CPU order
    # (its roll form): the dense_sxx kernel on the card, its plain version
    # elsewhere, the same bits; zero padding beyond ny adds nothing
    dsxx = _ops.dense_sxx(y_old, delta, ny, L, backend)
    return _with_deltas(agg, torch.stack([dsx, dsxl, dsx2, dsxl2, dsxx],
                                         dim=-2))


def apply_delta_dense_ref(agg, y_old: torch.Tensor, delta: torch.Tensor,
                          ny=None) -> Aggregates:
    """Per-lag loop oracle for :func:`apply_delta_dense` (roll, mask and
    sum per lag)."""
    nyb = y_old.shape[0]
    if ny is None:
        ny = nyb
    L = agg[0].shape[-1]
    dsx, dsxl, dsx2, dsxl2 = _dense_moment_deltas(y_old, delta, ny, L,
                                                  "auto")
    t = torch.arange(nyb, device=y_old.device)
    terms = []
    for ll in range(1, L + 1):
        mask = (t <= (ny - 1 - ll)).to(y_old.dtype)
        y_sh = torch.roll(y_old, -ll)
        d_sh = torch.roll(delta, -ll)
        terms.append(torch.sum(mask * (delta * y_sh + y_old * d_sh
                                       + delta * d_sh)))
    dtable = torch.stack([dsx, dsxl, dsx2, dsxl2, torch.stack(terms)])
    return Aggregates(*(agg[i] + dtable[i] for i in range(5)))


# ---------------------------------------------------------------------------
# Windowed exact update (sequential mode, Eq. 9)
# ---------------------------------------------------------------------------

def apply_delta_window(agg, y_old: torch.Tensor, delta_win: torch.Tensor,
                       start, *, W: int, L: int):
    """Exact Eq. 9 update for a delta confined to ``W`` contiguous points
    ``start .. start + W - 1`` (``start`` an int or 0-d tensor).

    Out-of-range window positions must carry zero delta.  The context is
    read at the start clipped into ``[0, ny]``; the head/tail masks use the
    unclipped start.  Cost O(W * L).  ``agg`` may be the ``Aggregates``
    tuple or the ``[5, L]`` table; the update comes back in the same form.
    """
    ny = y_old.shape[0]
    dtype = y_old.dtype
    dev = y_old.device
    y_pad = F.pad(y_old, (L, L + W))
    k = torch.arange(W + 2 * L, device=dev)
    start = torch.as_tensor(start, device=dev)
    ywin = y_pad[torch.clamp(start, 0, ny) + k]              # [W + 2L]
    j = torch.arange(W, device=dev)
    l = torch.arange(1, L + 1, device=dev)
    abs_t = start + j
    head = (abs_t[:, None] <= (ny - 1 - l)).to(dtype)       # [W, L]
    tail = (abs_t[:, None] >= l).to(dtype)
    d = delta_win[:, None]
    e = delta_win * (2.0 * ywin[L:L + W] + delta_win)
    y_fwd = ywin[(L + j)[:, None] + l[None, :]]              # [W, L]
    y_bwd = ywin[(L + j)[:, None] - l[None, :]]
    d_fwd = F.pad(delta_win, (0, L))[j[:, None] + l[None, :]]
    terms = torch.stack([d * head, d * tail, e[:, None] * head,
                         e[:, None] * tail,
                         d * (y_fwd * head + y_bwd * tail + d_fwd * head)])
    return _with_deltas(agg, torch.sum(terms, dim=1))        # [5, L]


def acf_after_single_delta(agg, y: torch.Tensor, idx: torch.Tensor,
                           dval: torch.Tensor) -> torch.Tensor:
    """Hypothetical ACF (Eq. 8) after adding ``dval[p]`` at ``idx[p]``,
    independently for each p: ``[P, L]``.  Thin alias of
    ``kernels.ref.acf_after_single_delta`` (one copy of the math, shared
    with the ``acf_impact`` kernel's plain version)."""
    return _ref.acf_after_single_delta(agg, y, idx, dval)


def acf_after_window_delta_ctx(agg, y_ctx, starts, dwins, *, ny: int, off):
    """Hypothetical ACF after each candidate's windowed delta applied
    alone (vectorized Eq. 9), ``[P, L]``; the math lives in
    ``kernels/ref.py``."""
    return _ref.acf_after_window_delta_ctx(agg, y_ctx, starts, dwins, ny=ny,
                                           off=off)


def acf_after_window_delta(agg, y: torch.Tensor, starts: torch.Tensor,
                           dwins: torch.Tensor) -> torch.Tensor:
    """Single-partition wrapper around :func:`acf_after_window_delta_ctx`."""
    L = agg[0].shape[-1]
    W = dwins.shape[1]
    y_ctx = F.pad(y, (L, L + W))
    return acf_after_window_delta_ctx(agg, y_ctx, starts, dwins,
                                      ny=y.shape[0], off=0)


# ---------------------------------------------------------------------------
# Segment geometry
# ---------------------------------------------------------------------------

def segment_interp(xr: torch.Tensor, prev: torch.Tensor, nxt: torch.Tensor,
                   i: torch.Tensor, W: int):
    """Interpolated values over the interior of segment (prev[i], nxt[i]),
    at its first ``W`` interior positions.

    Vectorized over ``i`` (per lane, ``[B, K]``, where ``xr`` is
    ``[B, n]``); returns ``(vals [..., W], absj [..., W], start [...],
    span [...])``.  ``absj`` are the (clamped) absolute
    indices the values land on; positions at or beyond the span carry
    values the caller must mask.  The line's multiply-add is rounded
    once, as XLA compiles it inside the reference's ``segment_deltas``,
    its strict compilation too (ROADMAP C19); :func:`interpolate_at`
    rounds it twice, as XLA does there.
    """
    n = xr.shape[-1]
    dt = xr.dtype
    p = gather_clamped(prev, i)
    q = gather_clamped(nxt, i)
    start = p + 1
    span = q - p - 1
    j = torch.arange(W, dtype=torch.int32, device=xr.device)
    absj = torch.clamp(start[..., None] + j, 0, n - 1)
    pcl = torch.clamp(p, 0, n - 1)[..., None]
    qcl = torch.clamp(q, 0, n - 1)[..., None]
    denom = torch.clamp_min((q - p).to(dt), 1.0)[..., None]
    t = (absj - pcl).to(dt) / denom
    xp = take(xr, pcl)
    vals = _ref.fma_rn(take(xr, qcl) - xp, t, xp)
    return vals, absj, start, span


def segment_deltas(xr: torch.Tensor, prev: torch.Tensor, nxt: torch.Tensor,
                   i: torch.Tensor, W: int):
    """Delta window from removing point(s) ``i``: the interior of segment
    (prev[i], nxt[i]) re-interpolated on the line between its endpoints.

    Returns ``(dwin [..., W], start [...], span [...])`` with deltas zero
    beyond the span (spans > W are truncated).  The paths take these
    windows from ``kernels.ops.segment_cells`` (its kernel on the card);
    this is its plain version's first half, with :func:`segment_interp`.
    """
    dt = xr.dtype
    vals, absj, start, span = segment_interp(xr, prev, nxt, i, W)
    j = torch.arange(W, dtype=torch.int32, device=xr.device)
    m = (j < span[..., None]).to(dt)
    dwin = (vals - take(xr, absj)) * m
    return dwin, start, span


# ---------------------------------------------------------------------------
# Alive-neighbor machinery (the paper's linked list, vectorized)
# ---------------------------------------------------------------------------

def alive_neighbors(alive: torch.Tensor):
    """For every index i, the nearest alive index strictly left / right
    (along the last axis, lane by lane).

    Returns ``(prev, nxt)`` int32 tensors; ``prev[i] = -1`` if none,
    ``nxt[i] = n`` if none.  O(n) through a cumulative max and a flipped
    cumulative min.
    """
    n = alive.shape[-1]
    idx = torch.arange(n, dtype=torch.int32, device=alive.device)
    left_ids = torch.where(alive, idx, -1)
    prev_incl = torch.cummax(left_ids, dim=-1).values
    prev = F.pad(prev_incl[..., :-1], (1, 0), value=-1)
    right_ids = torch.where(alive, idx, n)
    nxt_incl = torch.flip(
        torch.cummin(torch.flip(right_ids, (-1,)), dim=-1).values, (-1,))
    nxt = F.pad(nxt_incl[..., 1:], (0, 1), value=n)
    return prev, nxt


def neighbors_after_removal(prev: torch.Tensor, nxt: torch.Tensor,
                            removed: torch.Tensor):
    """``alive_neighbors`` after removing an independent set, by pointer
    jump: any index whose neighbor was removed inherits that neighbor's
    neighbor (a removed point's own neighbors are alive)."""
    n = prev.shape[-1]
    pj = torch.clamp(prev, 0, n - 1)
    qj = torch.clamp(nxt, 0, n - 1)
    prev_new = torch.where(take(removed, pj) & (prev >= 0), take(prev, pj),
                           prev)
    nxt_new = torch.where(take(removed, qj) & (nxt <= n - 1), take(nxt, qj),
                          nxt)
    return prev_new, nxt_new


def interpolate_at(x: torch.Tensor, prev: torch.Tensor, nxt: torch.Tensor,
                   i: torch.Tensor) -> torch.Tensor:
    """Value of the line through the alive neighbors of i, evaluated at i
    (lane by lane for ``x [B, n]``)."""
    n = x.shape[-1]
    p = torch.clamp(prev, 0, n - 1)
    q = torch.clamp(nxt, 0, n - 1)
    xp, xq = take(x, p), take(x, q)
    denom = torch.clamp_min((q - p).to(x.dtype), 1.0)
    t = (i - p).to(x.dtype) / denom
    return xp + (xq - xp) * t
