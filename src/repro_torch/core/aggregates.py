"""Incremental maintenance of the ACF aggregates (paper Eqs. 8-11; port of
``repro/core/aggregates.py``).

* ``apply_delta_dense`` — exact update from a dense delta vector (the
  rounds mode: one O(nL) update per round, including the cross-lag
  bilinear term across all of the round's segments).
* the alive-neighbor geometry: ``alive_neighbors``,
  ``neighbors_after_removal``, ``interpolate_at`` and the segment deltas.

The interpolation arithmetic follows the reference op for op, so the
reconstruction ``xr`` that the compressor carries is exactly the one
``core.cameo._reconstruct`` rebuilds from the kept points.

All functions operate on the target series ``y`` (the raw series for
``kappa == 1``, the tumbling-window aggregate series for Def. 2).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.acf import Aggregates
from repro_torch.kernels.ref import gather_clamped


# ---------------------------------------------------------------------------
# Dense exact update (rounds mode)
# ---------------------------------------------------------------------------

def _dense_moment_deltas(y_old, delta, ny, L):
    l = torch.arange(1, L + 1, device=y_old.device)
    cd = torch.cumsum(delta, dim=0)
    e = delta * (2.0 * y_old + delta)
    ce = torch.cumsum(e, dim=0)
    dtot, etot = cd[-1], ce[-1]
    dsx = gather_clamped(cd, ny - 1 - l)
    dsx2 = gather_clamped(ce, ny - 1 - l)
    dsxl = dtot - gather_clamped(cd, l - 1)
    dsxl2 = etot - gather_clamped(ce, l - 1)
    return dsx, dsxl, dsx2, dsxl2


def _with_deltas(agg, dtable):
    if isinstance(agg, torch.Tensor):
        return agg + dtable
    return Aggregates(*(agg[i] + dtable[i] for i in range(5)))


def apply_delta_dense(agg, y_old: torch.Tensor, delta: torch.Tensor,
                      ny=None):
    """Exact aggregate update for an arbitrary dense delta vector.

    ``y_old`` is the reconstruction before the update.  The four moment
    sums cost O(ny + L) through cumulative sums; the bilinear ``sxx`` term
    is two ``[nyb] x [nyb, L]`` products against shift views.

    ``agg`` may be the ``Aggregates`` tuple or the packed ``[5, L]`` table
    (the rounds-mode carry); the update comes back in the same form.
    ``ny`` (int or 0-d tensor) gives the valid length when ``y_old`` and
    ``delta`` live in a zero-padded bucket; both must be zero beyond it.
    """
    nyb = y_old.shape[0]
    if ny is None:
        ny = nyb
    L = agg[0].shape[-1]
    dsx, dsxl, dsx2, dsxl2 = _dense_moment_deltas(y_old, delta, ny, L)
    # new*new - old*old expanded over lag shifts:
    #   d_t*y_{t+l} + y_t*d_{t+l} + d_t*d_{t+l} = d_t*(y+d)_{t+l} + y_t*d_{t+l}
    # Zero padding beyond ny nulls every invalid pair, so no lag mask.
    z_pad = F.pad(y_old + delta, (0, L))
    d_pad = F.pad(delta, (0, L))
    dsxx = (delta @ z_pad.unfold(0, L, 1)[1:nyb + 1]
            + y_old @ d_pad.unfold(0, L, 1)[1:nyb + 1])
    return _with_deltas(agg, torch.stack([dsx, dsxl, dsx2, dsxl2, dsxx]))


def apply_delta_dense_ref(agg, y_old: torch.Tensor, delta: torch.Tensor,
                          ny=None) -> Aggregates:
    """Per-lag loop oracle for :func:`apply_delta_dense` (roll, mask and
    sum per lag)."""
    nyb = y_old.shape[0]
    if ny is None:
        ny = nyb
    L = agg[0].shape[-1]
    dsx, dsxl, dsx2, dsxl2 = _dense_moment_deltas(y_old, delta, ny, L)
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
# Segment geometry
# ---------------------------------------------------------------------------

def segment_interp(xr: torch.Tensor, prev: torch.Tensor, nxt: torch.Tensor,
                   i: torch.Tensor, W: int):
    """Interpolated values over the interior of segment (prev[i], nxt[i]),
    at its first ``W`` interior positions.

    Vectorized over ``i``; returns ``(vals [..., W], absj [..., W],
    start [...], span [...])``.  ``absj`` are the (clamped) absolute
    indices the values land on; positions at or beyond the span carry
    values the caller must mask.  The arithmetic matches
    :func:`interpolate_at` bit for bit.
    """
    n = xr.shape[0]
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
    xp = xr[pcl]
    vals = xp + (xr[qcl] - xp) * t
    return vals, absj, start, span


def segment_deltas(xr: torch.Tensor, prev: torch.Tensor, nxt: torch.Tensor,
                   i: torch.Tensor, W: int):
    """Delta window from removing point(s) ``i``: the interior of segment
    (prev[i], nxt[i]) re-interpolated on the line between its endpoints.

    Returns ``(dwin [..., W], start [...], span [...])`` with deltas zero
    beyond the span (spans > W are truncated).
    """
    dt = xr.dtype
    vals, absj, start, span = segment_interp(xr, prev, nxt, i, W)
    j = torch.arange(W, dtype=torch.int32, device=xr.device)
    m = (j < span[..., None]).to(dt)
    dwin = (vals - xr[absj]) * m
    return dwin, start, span


# ---------------------------------------------------------------------------
# Alive-neighbor machinery (the paper's linked list, vectorized)
# ---------------------------------------------------------------------------

def alive_neighbors(alive: torch.Tensor):
    """For every index i, the nearest alive index strictly left / right.

    Returns ``(prev, nxt)`` int32 tensors; ``prev[i] = -1`` if none,
    ``nxt[i] = n`` if none.  O(n) through a cumulative max and a flipped
    cumulative min.
    """
    n = alive.shape[0]
    idx = torch.arange(n, dtype=torch.int32, device=alive.device)
    left_ids = torch.where(alive, idx, -1)
    prev_incl = torch.cummax(left_ids, dim=0).values
    prev = F.pad(prev_incl[:-1], (1, 0), value=-1)
    right_ids = torch.where(alive, idx, n)
    nxt_incl = torch.flip(
        torch.cummin(torch.flip(right_ids, (0,)), dim=0).values, (0,))
    nxt = F.pad(nxt_incl[1:], (0, 1), value=n)
    return prev, nxt


def neighbors_after_removal(prev: torch.Tensor, nxt: torch.Tensor,
                            removed: torch.Tensor):
    """``alive_neighbors`` after removing an independent set, by pointer
    jump: any index whose neighbor was removed inherits that neighbor's
    neighbor (a removed point's own neighbors are alive)."""
    n = prev.shape[0]
    pj = torch.clamp(prev, 0, n - 1)
    qj = torch.clamp(nxt, 0, n - 1)
    prev_new = torch.where(removed[pj] & (prev >= 0), prev[pj], prev)
    nxt_new = torch.where(removed[qj] & (nxt <= n - 1), nxt[qj], nxt)
    return prev_new, nxt_new


def interpolate_at(x: torch.Tensor, prev: torch.Tensor, nxt: torch.Tensor,
                   i: torch.Tensor) -> torch.Tensor:
    """Value of the line through the alive neighbors of i, evaluated at i."""
    n = x.shape[0]
    p = torch.clamp(prev, 0, n - 1)
    q = torch.clamp(nxt, 0, n - 1)
    xp, xq = x[p], x[q]
    denom = torch.clamp_min((q - p).to(x.dtype), 1.0)
    t = (i - p).to(x.dtype) / denom
    return xp + (xq - xp) * t
