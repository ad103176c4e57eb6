"""Functional-approximation lossy baselines: PMC, Swing, Sim-Piece (port
of ``repro/baselines/functional.py``).

Each exposes ``<name>_compress(x, err, *, device=) -> (recon, stored)``
where ``err`` is the per-value error bound and ``stored`` is the number of
64-bit values the compressed form needs (the paper's accounting).  The ACF
constraint is enforced externally by trial and error over ``err``
(``baselines.constrain``), as the paper does for these methods.

PMC's and Swing's scans run in the ``segment_scan`` kernel on the card
(``kernels/segment_scan.py``; its plain version on the CPU), and their
segment post-processing in PyTorch on the same device.  Sim-Piece is a
host loop over the series with a dictionary of intercept groups, as in the
reference; its reconstruction goes to the caller's device.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.cameo import _device
from repro_torch.kernels.segment_scan import segment_scan_cuda


# ---------------------------------------------------------------------------
# PMC-Mean (Lazaridis & Mehrotra): constant segments, max error <= err
# ---------------------------------------------------------------------------

def pmc_compress(x, err: float, *, device="cuda"):
    x = torch.as_tensor(x).to(_device(device))
    (brks,) = segment_scan_cuda(x, err, "pmc")
    seg_id = torch.cumsum(brks.to(torch.int32), 0)
    nseg = int(seg_id[-1]) + 1
    # PMC emits the segment midrange: |x - (min+max)/2| <= err is exactly the
    # invariant the (max - min) <= 2*err check maintains.
    seg = seg_id.long()
    lo = torch.empty(nseg, dtype=x.dtype, device=x.device).scatter_reduce(
        0, seg, x, "amin", include_self=False)
    hi = torch.empty(nseg, dtype=x.dtype, device=x.device).scatter_reduce(
        0, seg, x, "amax", include_self=False)
    mid = 0.5 * (lo + hi)
    # storage: (value, run length) per segment
    return mid[seg], 2 * nseg


# ---------------------------------------------------------------------------
# Swing filter (Elmeleegy et al.): connected linear segments via slope cones
# ---------------------------------------------------------------------------

def swing_compress(x, err: float, *, device="cuda"):
    x = torch.as_tensor(x, dtype=torch.float64).to(_device(device))
    n = x.shape[0]
    brks, t0s, x0s, us, ls = segment_scan_cuda(x, err, "swing")
    seg_id = torch.cumsum(brks.to(torch.int64), 0)
    nseg = int(seg_id[-1]) + 1
    # parameters at each segment's LAST point
    last_idx = torch.searchsorted(
        seg_id, torch.arange(nseg, device=x.device), right=True) - 1
    t0f = t0s[last_idx]
    x0f = x0s[last_idx]
    slope = 0.5 * (us[last_idx] + ls[last_idx])
    slope = torch.where(torch.isfinite(slope), slope, 0.0)
    t = torch.arange(n, dtype=torch.float64, device=x.device)
    # two roundings, as numpy's x0 + slope * dt (no fused multiply-add)
    recon = x0f[seg_id] + slope[seg_id] * (t - t0f[seg_id])
    # storage: swing stores one (value) per segment + final point (connected)
    return recon, 2 * nseg


# ---------------------------------------------------------------------------
# Sim-Piece (Kitsios et al. 2023): PLA with quantized intercepts, grouped
# ---------------------------------------------------------------------------

def simpiece_compress(x, err: float, *, device="cuda"):
    """Simplified Sim-Piece: greedy maximal segments whose intercept is
    quantized to a multiple of ``err``; segments grouped by intercept with
    overlapping slope intervals merged (the paper's storage trick).

    Storage model: per intercept group, 1 value for the intercept; per merged
    slope-interval, 1 value for the representative slope; per segment, 1
    value for its start offset.

    A host loop over the series (numpy), as in the reference; the
    reconstruction lands on ``device``.
    """
    dev = _device(device)
    x = (x.detach().cpu().numpy() if isinstance(x, torch.Tensor)
         else np.asarray(x)).astype(np.float64)
    n = x.shape[0]
    if err <= 0:
        return torch.from_numpy(x).to(dev), 2 * n
    xq = np.floor(x / err) * err + err / 2.0   # quantized intercepts

    segs = []  # (t0, b, lo_slope, hi_slope, end)
    t0, b = 0, xq[0]
    lo, hi = -np.inf, np.inf
    for t in range(1, n):
        dt_ = t - t0
        s_hi = (x[t] + err - b) / dt_
        s_lo = (x[t] - err - b) / dt_
        nlo, nhi = max(lo, s_lo), min(hi, s_hi)
        if nlo > nhi:
            segs.append((t0, b, lo, hi, t - 1))
            t0, b = t, xq[t]
            lo, hi = -np.inf, np.inf
        else:
            lo, hi = nlo, nhi
    segs.append((t0, b, lo, hi, n - 1))

    # group by intercept; merge segments whose slope intervals INTERSECT
    # (the shared slope must lie inside every member's interval, else the
    # per-point error bound breaks)
    groups: dict = {}
    for (t0, b, lo, hi, end) in segs:
        groups.setdefault(b, []).append((lo, hi, t0, end))
    stored = 0
    recon = np.empty(n)
    for b, items in groups.items():
        stored += 1  # intercept
        items.sort(key=lambda it: it[0])  # -inf (single-point) first
        merged: list = []  # (isect_lo, isect_hi, members)
        for lo, hi, t0, end in items:
            if merged:
                m_lo, m_hi, members = merged[-1]
                i_lo, i_hi = max(m_lo, lo), min(m_hi, hi)
                if i_lo <= i_hi:
                    merged[-1] = (i_lo, i_hi, members + [(t0, end)])
                    continue
            merged.append((lo, hi, [(t0, end)]))
        for m_lo, m_hi, members in merged:
            stored += 1  # representative slope
            if np.isfinite(m_lo) and np.isfinite(m_hi):
                s = 0.5 * (m_lo + m_hi)
            elif np.isfinite(m_lo):
                s = m_lo
            elif np.isfinite(m_hi):
                s = m_hi
            else:
                s = 0.0
            for (t0, end) in members:
                stored += 1  # segment start
                tt = np.arange(t0, end + 1)
                recon[t0:end + 1] = b + s * (tt - t0)
    return torch.from_numpy(recon).to(dev), stored
