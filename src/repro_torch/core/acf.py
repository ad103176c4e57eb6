"""Autocorrelation (ACF) and partial autocorrelation (PACF) machinery
(port of ``repro/core/acf.py``).

The non-stationary aggregate form (Eq. 2) is driven by the five per-lag
aggregates ``sx, sx_l, sx^2, sx_l^2, sxx_l`` (Eq. 7).  Index conventions
are 0-based: for lag ``l`` the head range is ``t in [0, n-1-l]`` and the
tail range ``t in [l, n-1]``; both have ``n - l`` elements.

The rounds mode's functions (``extract_aggregates_masked``,
``acf_from_aggregates``, ``aggregate_series``) also take a leading lane
axis: series ``[B, n]``, aggregates ``[B, L]`` (tables ``[B, 5, L]``),
valid lengths ``[B]``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels.ref import (agg_rows, div_exact, gather_clamped,
                                    lane_col, row_sum_xla, sqrt_rn)


class Aggregates(NamedTuple):
    """Per-lag ACF aggregates (Eq. 7). Each field has shape ``[L]``;
    entry ``j`` corresponds to lag ``l = j + 1``."""

    sx: torch.Tensor     # sum of head values        sum_{t<=n-1-l} x_t
    sxl: torch.Tensor    # sum of tail values        sum_{t>=l}     x_t
    sx2: torch.Tensor    # sum of head squares
    sxl2: torch.Tensor   # sum of tail squares
    sxx: torch.Tensor    # lagged product            sum_{t<=n-1-l} x_t x_{t+l}


def lags_arange(L: int, dtype=torch.float64, device=None) -> torch.Tensor:
    """The lags ``1..L`` as ``dtype`` values."""
    return torch.arange(1, L + 1, dtype=dtype, device=device)


def _moment_sums(x: torch.Tensor, L: int, n_valid, backend: str):
    from repro_torch.kernels.ops import prefix_sum  # deferred: kernels sit below core
    # one launch for both rows: on the card their chains run side by side
    csum, csum2 = prefix_sum(torch.stack([x, x * x], dim=-2),
                             backend).unbind(-2)
    total, total2 = csum[..., -1:], csum2[..., -1:]
    l = torch.arange(1, L + 1, device=x.device)
    # head sums: prefix up to index n-1-l; tail sums: total minus the
    # prefix up to l-1 (indices follow JAX's wrap-then-clamp gather rule).
    head = lane_col(n_valid, x) - 1 - l
    sx = gather_clamped(csum, head)
    sx2 = gather_clamped(csum2, head)
    sxl = total - gather_clamped(csum, l - 1)
    sxl2 = total2 - gather_clamped(csum2, l - 1)
    return sx, sxl, sx2, sxl2


def extract_aggregates(x: torch.Tensor, L: int,
                       backend: str = "auto") -> Aggregates:
    """ExtractAggregates (Algorithm 1): O(nL), dominated by ``sxx_l``.
    It and the moments' prefix sums go through the impact-engine backend
    (``kernels/ops.lag_dot`` and ``ops.prefix_sum``: the CUDA kernels for
    card tensors, the plain forms elsewhere)."""
    from repro_torch.kernels.ops import lag_dot  # deferred: kernels sit below core
    sx, sxl, sx2, sxl2 = _moment_sums(x, L, x.shape[0], backend)
    sxx = lag_dot(x, L, backend=backend)
    return Aggregates(sx=sx, sxl=sxl, sx2=sx2, sxl2=sxl2, sxx=sxx)


def extract_aggregates_masked(x: torch.Tensor, L: int, n_valid,
                              backend: str = "auto") -> Aggregates:
    """ExtractAggregates over a zero-padded buffer: aggregates of
    ``x[:n_valid]``, where ``n_valid`` may be a 0-d device tensor.

    ``x`` must be zero beyond ``n_valid`` (the padded-bucket discipline of
    the rounds mode): the tail sums and the lagged products are then exact
    as they are, and only the head prefix sums need dynamic gathers.  With
    lanes, ``x`` is ``[B, n]`` and ``n_valid`` ``[B]``.
    """
    from repro_torch.kernels.ops import lag_dot  # deferred: kernels sit below core
    sx, sxl, sx2, sxl2 = _moment_sums(x, L, n_valid, backend)
    sxx = lag_dot(x, L, backend=backend)
    return Aggregates(sx=sx, sxl=sxl, sx2=sx2, sxl2=sxl2, sxx=sxx)


def acf_from_aggregates(agg, n) -> torch.Tensor:
    """Eq. (2).  Returns the ACF for lags ``1..L`` (shape ``[..., L]``).

    ``agg`` is the ``Aggregates`` tuple or the ``[..., 5, L]`` table; ``n``
    a Python int, a 0-d integer tensor or one per lane (``[B]``).
    """
    sx, sxl, sx2, sxl2, sxx = agg_rows(agg)
    L = sx.shape[-1]
    m = lane_col(n, sx) - torch.arange(1, L + 1, dtype=sx.dtype,
                                        device=sx.device)
    num = m * sxx - sx * sxl
    var_head = m * sx2 - sx * sx
    var_tail = m * sxl2 - sxl * sxl
    denom2 = var_head * var_tail
    tiny = 1e-30
    denom = sqrt_rn(torch.clamp_min(denom2, tiny))
    return torch.where(denom2 > tiny, num / denom, 0.0)


def acf(x: torch.Tensor, L: int) -> torch.Tensor:
    """Non-stationary ACF (Eq. 2) computed from scratch.  Shape ``[L]``."""
    return acf_from_aggregates(extract_aggregates(x, L), x.shape[0])


def acf_stationary(x: torch.Tensor, L: int) -> torch.Tensor:
    """Eq. (1): the stationary ACF with the global mean and variance
    (oracle and tests), ``[L]``.  Every sum runs in XLA's row-reduce order
    (``ref.row_sum_xla``) and the means divide exactly, as the JAX
    reference's ``jnp.mean``/``jnp.sum`` do."""
    n = x.shape[0]
    mu = div_exact(row_sum_xla(x), n)
    xc = x - mu
    var = div_exact(row_sum_xla(xc ** 2), n)
    l = torch.arange(1, L + 1, device=x.device)
    t = torch.arange(n, device=x.device)
    shifted = xc[(t[None, :] + l[:, None]) % n]                 # roll by -l
    prods = torch.where(t[None, :] <= n - 1 - l[:, None], xc * shifted, 0.0)
    return row_sum_xla(prods) / ((n - l).to(x.dtype) * var)


def pacf_from_acf(r: torch.Tensor) -> torch.Tensor:
    """Durbin–Levinson recursion (Eq. 3), O(L^2), over the last axis.

    ``r`` is the ACF for lags 1..L (any leading batch dims); returns
    ``phi_{l,l}`` for l = 1..L.
    """
    L = r.shape[-1]
    if L == 1:
        return r
    dtype, dev = r.dtype, r.device
    k = torch.arange(1, L + 1, device=dev)
    phi = torch.zeros_like(r)
    phi[..., 0] = r[..., 0]                # phi_{1,k} row (k=1..L)
    diag = torch.zeros_like(r)
    diag[..., 0] = r[..., 0]
    for l in range(2, L + 1):
        kmask = (k <= l - 1).to(dtype)
        # r_{l-k} for k = 1..l-1; clamped indices, the mask handles validity
        rev = torch.clamp(l - k - 1, 0, L - 1)
        r_lk = r[..., rev]
        num = r[..., l - 1] - torch.sum(phi * r_lk * kmask, dim=-1)
        den = 1.0 - torch.sum(phi * r * kmask, dim=-1)
        den = torch.where(torch.abs(den) < 1e-12, 1e-12, den)
        phi_ll = num / den
        # phi_{l,k} = phi_{l-1,k} - phi_ll * phi_{l-1,l-k}
        phi_new = (phi - phi_ll[..., None] * phi[..., rev]) * kmask
        phi_new[..., l - 1] = phi_ll
        phi = phi_new
        diag[..., l - 1] = phi_ll
    return diag


def pacf(x: torch.Tensor, L: int) -> torch.Tensor:
    return pacf_from_acf(acf(x, L))


# ---------------------------------------------------------------------------
# Tumbling-window aggregation (SIP-on-Aggregates, Def. 2)
# ---------------------------------------------------------------------------

def aggregate_series(x: torch.Tensor, kappa: int,
                     agg: str = "mean") -> torch.Tensor:
    """``AGG_kappa(X)``: tumbling windows of ``kappa`` points over the last
    axis.

    ``n`` must be divisible by ``kappa`` (callers pad or trim).  The mean
    and the sum add a window's points in XLA's row-reduce order
    (``kernels.ref.row_sum_xla``), the JAX reference's, on every device;
    the mean then divides by ``kappa`` exactly, the op-by-op value (XLA's
    default compilation multiplies by ``1/kappa`` instead; ROADMAP C1/C2).
    """
    if kappa == 1:
        return x
    n = x.shape[-1]
    if n % kappa:
        raise ValueError(f"length {n} not divisible by kappa={kappa}")
    xw = x.reshape(*x.shape[:-1], n // kappa, kappa)
    if agg == "mean":
        return div_exact(row_sum_xla(xw), kappa)
    if agg == "sum":
        return row_sum_xla(xw)
    if agg == "max":
        return xw.amax(dim=-1)
    if agg == "min":
        return xw.amin(dim=-1)
    raise ValueError(f"unknown aggregation {agg!r}")
