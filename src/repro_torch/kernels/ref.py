"""Plain PyTorch forms of the Eq. 2/7/8 per-lag math (port of
``repro/kernels/ref.py``) — the single source of the formulas and the
oracles of the hand-written kernels.

Aggregate arguments are any structure indexable as five per-lag ``[L]``
rows ``(sx, sxl, sx2, sxl2, sxx)``: the ``core.acf.Aggregates`` tuple or
the packed ``[5, L]`` table.  ``ny`` arguments may be Python ints or
0-d integer tensors (the rounds mode keeps the valid length on the
device).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

KERNEL_MEASURES = ("mae", "rmse", "cheb")


def gather_clamped(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[idx]`` along the first axis with JAX's gather index rule:
    negative indices wrap once (``idx + n``), then every index is clamped
    into ``[0, n)``."""
    n = x.shape[0]
    idx = torch.where(idx < 0, idx + n, idx)
    return x[idx.clamp(0, n - 1)]


def acf_from_moments(sx, sxl, sx2, sxl2, sxx, m):
    """Eq. 2: normalized per-lag ACF from the five moment sums.

    Broadcasts over any leading batch dims; ``m = ny - l`` per lag.
    """
    num = m * sxx - sx * sxl
    den2 = (m * sx2 - sx * sx) * (m * sxl2 - sxl * sxl)
    # a Python scalar, not a device tensor: no host-to-device copy per call
    tiny = 1e-30
    den = torch.sqrt(torch.clamp_min(den2, tiny))
    return torch.where(den2 > tiny, num / den, 0.0)


def head_tail_masks(idx: torch.Tensor, ny, L: int, dtype):
    """Head/tail validity masks ``[..., L]`` for absolute indices ``idx``:
    ``head[..., l-1] = idx <= ny-1-l`` and ``tail[..., l-1] = idx >= l``."""
    l = torch.arange(1, L + 1, device=idx.device)
    head = (idx[..., None] <= (ny - 1 - l)).to(dtype)
    tail = (idx[..., None] >= l).to(dtype)
    return head, tail


def sum_in_order(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Sum over ``dim`` one term at a time, first to last.

    The float32 ranking sums in this fixed order on every device, and the
    CUDA kernels repeat it (without fused multiply-adds), so the card's
    ranking keys equal the CPU's bit for bit and a run's trajectory does
    not depend on where it ran.  ``torch.sum``'s order is not specified
    and differs between CPU builds and the card.
    """
    x = torch.movedim(x, dim, 0)
    acc = x[0]
    for i in range(1, x.shape[0]):
        acc = acc + x[i]
    return acc


def div_exact(x: torch.Tensor, k: int) -> torch.Tensor:
    """``x / k`` rounded once on every device.  On the card, a division by
    a Python scalar multiplies by the scalar's reciprocal (rounded twice);
    a 0-d tensor divisor keeps the true division the CPU and the kernels
    use."""
    return x / torch.full((), k, dtype=x.dtype, device=x.device)


def measure_rows(rows: torch.Tensor, p0: torch.Tensor,
                 measure: str) -> torch.Tensor:
    """Kernel-supported deviation measures over ``[..., L]`` ACF rows
    (lag sums in order, see :func:`sum_in_order`)."""
    diff = rows - p0[None, :]
    L = diff.shape[-1]
    if measure == "mae":
        return div_exact(sum_in_order(torch.abs(diff)), L)
    if measure == "rmse":
        return torch.sqrt(div_exact(sum_in_order(diff * diff), L))
    if measure == "cheb":
        return torch.amax(torch.abs(diff), dim=-1)
    raise ValueError(measure)


def as_table(agg) -> torch.Tensor:
    """The packed ``[5, L]`` moment table for any aggregate structure."""
    if isinstance(agg, torch.Tensor):
        return agg
    return torch.stack([agg[0], agg[1], agg[2], agg[3], agg[4]])


def acf_from_table(rows: torch.Tensor, m) -> torch.Tensor:
    """Eq. 2 over packed moment rows ``[..., 5, L]`` → ACF ``[..., L]``."""
    return acf_from_moments(rows[..., 0, :], rows[..., 1, :], rows[..., 2, :],
                            rows[..., 3, :], rows[..., 4, :], m)


# ---------------------------------------------------------------------------
# Eq. 8 — hypothetical ACF after a single-point delta (Algorithm 2 ranking)
# ---------------------------------------------------------------------------

def acf_after_single_delta(agg, y: torch.Tensor, idx: torch.Tensor,
                           dval: torch.Tensor, *, ny=None) -> torch.Tensor:
    """Hypothetical ACF (Eq. 8) after adding ``dval[p]`` at ``idx[p]``,
    independently for each p.  Returns ``[P, L]``.

    ``ny`` overrides the valid length when ``y`` lives in a zero-padded
    bucket.
    """
    if ny is None:
        ny = y.shape[0]
    L = agg[0].shape[-1]
    dtype = y.dtype
    head, tail = head_tail_masks(idx, ny, L, dtype)        # [P, L]
    l = torch.arange(1, L + 1, device=y.device)
    y_pad = F.pad(y, (L, L))
    y_fwd = gather_clamped(y_pad, (idx + L)[:, None] + l[None, :])
    y_bwd = gather_clamped(y_pad, (idx + L)[:, None] - l[None, :])
    y_at = gather_clamped(y, idx)                          # [P]

    d = dval[:, None]                                      # [P, 1]
    e = (dval * (2.0 * y_at + dval))[:, None]              # [P, 1]

    tab = as_table(agg)
    sx = tab[0][None, :] + d * head
    sxl = tab[1][None, :] + d * tail
    sx2 = tab[2][None, :] + e * head
    sxl2 = tab[3][None, :] + e * tail
    sxx = tab[4][None, :] + d * (y_fwd * head + y_bwd * tail)

    m = (ny - l).to(dtype)[None, :]
    return acf_from_moments(sx, sxl, sx2, sxl2, sxx, m)


def acf_impact_ref(y, dval, agg_table, p0, *, L: int, measure: str = "mae"):
    """Oracle for ``kernels.acf_impact`` at full length: Algorithm-2
    impacts for all points."""
    n = y.shape[0]
    idx = torch.arange(n, dtype=torch.int32, device=y.device)
    rows = acf_after_single_delta(agg_table, y, idx, dval)  # [n, L]
    return measure_rows(rows, p0, measure)


# ---------------------------------------------------------------------------
# Eq. 7 — lagged products (ExtractAggregates hot term), cross/halo'd form
# ---------------------------------------------------------------------------

def lag_xdot(a: torch.Tensor, b_ext: torch.Tensor, *, L: int) -> torch.Tensor:
    """``out[l-1] = sum_{t < m} a[t] * b_ext[t + l]`` for l in 1..L, as one
    ``[m] x [m, L]`` product against a shift view of ``b_ext``.

    ``b_ext`` has length ``m + L`` (the caller appends an L-point halo —
    zeros for a plain series, the next chunk's head for partitioned work).
    """
    m = a.shape[0]
    shifted = b_ext.unfold(0, L, 1)[1:m + 1]               # [m, L]
    return a @ shifted


def lag_xdot_ref(a: torch.Tensor, b_ext: torch.Tensor, *,
                 L: int) -> torch.Tensor:
    """Loop oracle for :func:`lag_xdot` (one slice per lag)."""
    m = a.shape[0]
    return torch.stack([torch.sum(a * b_ext[l:l + m])
                        for l in range(1, L + 1)])


def lag_dot_ref(y: torch.Tensor, *, L: int) -> torch.Tensor:
    """Oracle for ``kernels.lag_dot``: ``sxx[l-1] = sum_t y_t y_{t+l}``."""
    return lag_xdot_ref(y, F.pad(y, (0, L)), L=L)
