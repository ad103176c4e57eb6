"""Plain PyTorch forms of the Eq. 2/7/8 per-lag math (port of
``repro/kernels/ref.py``) — the single source of the formulas and the
oracles of the hand-written kernels.

Aggregate arguments are the five per-lag rows ``(sx, sxl, sx2, sxl2,
sxx)``: the ``core.acf.Aggregates`` tuple or the packed ``[5, L]`` table.
``ny`` arguments may be Python ints or 0-d integer tensors (the rounds
mode keeps the valid length on the device).

Lanes.  A batch of series (``compress_batch``) carries a leading lane
axis: series ``[B, n]``, tables ``[B, 5, L]``, ``ny`` ``[B]``.  The
functions here that the rounds mode calls take it, and compute each lane
exactly as they compute the lane alone.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

KERNEL_MEASURES = ("mae", "rmse", "cheb")


def take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[..., idx]`` lane by lane along the last axis.

    A 1-D ``x`` takes any index shape (``x[idx]``).  For ``x [*lanes, n]``
    a 1-D ``idx`` is one row of indices for every lane; otherwise the
    leading dimensions of ``idx`` are the lanes' (size 1 broadcasts) and
    the rest index each lane.
    """
    if x.dim() == 1:
        return x[idx]
    if x.dim() == 2 and x.shape[0] == 1:    # one lane: plain indexing
        out = x[0][idx]
        return out[None] if idx.dim() == 1 else out
    lead = x.shape[:-1]
    if idx.shape[:-1] == lead:              # one index row a lane
        return torch.gather(x, -1, idx.long())
    if idx.dim() == 1:                      # one row for every lane
        return torch.gather(x, -1, idx.long().expand(*lead, -1))
    rest = idx.shape[len(lead):]
    flat = idx.expand(*lead, *rest).reshape(*lead, -1)
    return torch.gather(x, -1, flat.long()).reshape(*lead, *rest)


def lane_col(v, x: torch.Tensor):
    """A per-lane scalar ``v`` (Python number, 0-d or ``[*lanes]``) shaped
    to broadcast against the last axis of ``x [*lanes, n]``; unchanged for
    a 1-D ``x``."""
    if x.dim() == 1:
        return v
    v = torch.as_tensor(v, device=x.device)
    if v.dim() == 0:
        return v.reshape((1,) * x.dim())
    return v.reshape(*v.shape, *((1,) * (x.dim() - v.dim())))


def gather_clamped(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[..., idx]`` (see :func:`take`) with JAX's gather index rule:
    negative indices wrap once (``idx + n``), then every index is clamped
    into ``[0, n)``."""
    n = x.shape[-1]
    idx = torch.where(idx < 0, idx + n, idx)
    return take(x, idx.clamp(0, n - 1))


class _SqrtRN(torch.autograd.Function):
    """IEEE square root of a CPU tensor (numpy's), with torch's derivative
    ``g / (2 * sqrt(x))``."""

    @staticmethod
    def forward(ctx, x):
        out = torch.from_numpy(np.asarray(np.sqrt(x.detach().numpy())))
        ctx.save_for_backward(out)
        return out

    @staticmethod
    def backward(ctx, g):
        (out,) = ctx.saved_tensors
        return g / (2 * out)


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded square root on every device, as XLA and the
    CUDA kernels compute it.  On the card that is ``torch.sqrt``; torch's
    vectorized CPU square root is not correctly rounded (1 ulp off for
    about 0.7% of float32 and float64 inputs), so a CPU tensor takes
    numpy's."""
    if x.device.type != "cpu":
        return torch.sqrt(x)
    return _SqrtRN.apply(x)


def acf_from_moments(sx, sxl, sx2, sxl2, sxx, m):
    """Eq. 2: normalized per-lag ACF from the five moment sums.

    Broadcasts over any leading batch dims; ``m = ny - l`` per lag.
    """
    num = m * sxx - sx * sxl
    den2 = (m * sx2 - sx * sx) * (m * sxl2 - sxl * sxl)
    # a Python scalar, not a device tensor: no host-to-device copy per call
    tiny = 1e-30
    den = sqrt_rn(torch.clamp_min(den2, tiny))
    return torch.where(den2 > tiny, num / den, 0.0)


def head_tail_masks(idx: torch.Tensor, ny, L: int, dtype):
    """Head/tail validity masks ``[..., L]`` for absolute indices ``idx``:
    ``head[..., l-1] = idx <= ny-1-l`` and ``tail[..., l-1] = idx >= l``."""
    l = torch.arange(1, L + 1, device=idx.device)
    head = (idx[..., None] <= (ny - 1 - l)).to(dtype)
    tail = (idx[..., None] >= l).to(dtype)
    return head, tail


def interior_windows(starts: torch.Tensor, W: int, L: int, ny):
    """Where a window ``[s, s + W)`` has every head and tail mask of every
    lag 1 (``s >= L`` and ``s + W - 1 <= ny - 1 - L``): the Eq. 9 window
    kernels' fast-path test, per start."""
    return (starts >= L) & (starts + W - 1 <= ny - 1 - L)


# XLA's CPU row-reduce (``x.reshape(-1, k).sum(1)`` compiled, fused or
# not, in either float type and whatever the row count) sums a row of up to
# 32 values one add at a time from +0.  A longer row is a reduce window of
# 32 values, stride 32, over the row padded with zeros to a multiple of 32
# (the smaller half of the padding in front): each window summed the same
# way, then the window sums reduced by the same rule, recursively.  So up
# to 1,024 values the rows split into ceil(k / 32) blocks, the middle ones
# of 32 values and the first and last sharing the rest (the first takes
# the odd one), added first to last.  Probed over k = 1..128 and held to
# 18,432.
_XLA_ROW_BLOCK = 32


def xla_row_blocks(k: int) -> list:
    """The block sizes of one level of XLA's row-reduce over ``k``
    values, in order (the block sums are reduced by the same rule)."""
    if k <= _XLA_ROW_BLOCK:
        return [k]
    pad = -k % _XLA_ROW_BLOCK
    lo = pad // 2
    nw = (k + pad) // _XLA_ROW_BLOCK
    return ([_XLA_ROW_BLOCK - lo] + [_XLA_ROW_BLOCK] * (nw - 2)
            + [_XLA_ROW_BLOCK - (pad - lo)])


def chain_sum(v: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis one add at a time from +0, in ``v``'s type.
    A float64 CPU tensor takes ``torch.cumsum``'s last value, which the CPU
    computes by exactly these adds (one op however long the axis;
    ``tests/test_torch_sums.py`` holds it to the chain); elsewhere one add
    a column."""
    if v.device.type == "cpu" and v.dtype == torch.float64:
        return torch.cumsum(v, -1)[..., -1] + 0.0
    acc = v[..., 0] + 0.0
    for j in range(1, v.shape[-1]):
        acc = acc + v[..., j]
    return acc


def row_sum_xla(xw: torch.Tensor) -> torch.Tensor:
    """``xw [..., k]`` summed over the last axis in XLA's row-reduce order
    (see ``xla_row_blocks``): exact elementwise adds over strided columns,
    the blocks side by side, then the block sums by the same rule, so the
    card's sums equal the CPU's and the JAX reference's bit for bit.  A
    block shorter than the longest is padded with zeros, which add nothing
    to a sum begun at +0."""
    k = xw.shape[-1]
    sizes = xla_row_blocks(k)
    if len(sizes) == 1:
        return chain_sum(xw)
    w = max(sizes)
    if all(b == w for b in sizes):
        blocks = xw.reshape(*xw.shape[:-1], len(sizes), w)
    else:
        cols, start = [], 0
        for b in sizes:
            cols += list(range(start, start + b)) + [k] * (w - b)
            start += b
        idx = torch.tensor(cols, device=xw.device)
        blocks = F.pad(xw, (0, 1))[..., idx].reshape(*xw.shape[:-1],
                                                     len(sizes), w)
    return row_sum_xla(chain_sum(blocks))


def _two_sum(a: torch.Tensor, b: torch.Tensor):
    """``(s, e)`` with ``s = fl(a + b)`` and ``s + e = a + b`` exactly."""
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def _split(a: torch.Tensor):
    """Veltkamp's split: ``a = hi + lo``, each half of the significand."""
    c = a * (134217729.0 if a.dtype == torch.float64 else 4097.0)
    hi = c - (c - a)
    return hi, a - hi


def fma_rn(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor):
    """``a * b + c`` rounded once, on every device, in the operands' type
    (float32 or float64): XLA contracts the reference's segment
    interpolation into a fused multiply-add even in its strict compilation
    (ROADMAP C19), and torch has no fused form that rounds once on the
    CPU.  Boldo and Melquiond's emulation: the exact product (Dekker),
    its sum with ``c`` (TwoSum), the two tails added with rounding to odd,
    then the last sum rounded to nearest.  Assumes no overflow and no
    subnormal products (the interpolation's operands)."""
    p = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    pe = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    th, tl = _two_sum(c, p)
    v, ve = _two_sum(tl, pe)
    # round to odd: an inexact sum with an even last bit steps to its
    # other neighbour, toward the exact sum
    ibits = {torch.float64: torch.int64, torch.float32: torch.int32}[v.dtype]
    even = (v.view(ibits) & 1) == 0
    inf = torch.full((), float("inf"), dtype=v.dtype, device=v.device)
    v = torch.where((ve != 0) & even,
                    torch.nextafter(v, torch.where(ve > 0, inf, -inf)), v)
    return th + v


def div_exact(x: torch.Tensor, k: int) -> torch.Tensor:
    """``x / k`` rounded once on every device.  On the card, a division by
    a Python scalar multiplies by the scalar's reciprocal (rounded twice);
    a 0-d tensor divisor keeps the true division the CPU and the kernels
    use."""
    return x / torch.full((), k, dtype=x.dtype, device=x.device)


def measure_rows(rows: torch.Tensor, p0: torch.Tensor,
                 measure: str) -> torch.Tensor:
    """Kernel-supported deviation measures over ``[..., K, L]`` ACF rows
    against ``p0 [..., L]``.

    mae's and rmse's lag terms are summed in XLA's row-reduce order
    (:func:`row_sum_xla`), the order of the reference's ``jnp.mean`` over
    the lags, and divided exactly; the kernels walk the same blocks
    (``rn::row_sum``).  Up to 32 lags that order is one chain from the
    first lag to the last."""
    diff = rows - p0.unsqueeze(-2)
    L = diff.shape[-1]
    if measure == "mae":
        return div_exact(row_sum_xla(torch.abs(diff)), L)
    if measure == "rmse":
        return sqrt_rn(div_exact(row_sum_xla(diff * diff), L))
    if measure == "cheb":
        return torch.amax(torch.abs(diff), dim=-1)
    raise ValueError(measure)


def as_table(agg) -> torch.Tensor:
    """The packed ``[..., 5, L]`` moment table for any aggregate
    structure."""
    if isinstance(agg, torch.Tensor):
        return agg
    return torch.stack([agg[0], agg[1], agg[2], agg[3], agg[4]], dim=-2)


def agg_rows(agg) -> tuple:
    """The five per-lag rows ``[..., L]`` of a table or an
    ``Aggregates`` tuple."""
    if isinstance(agg, torch.Tensor):
        return tuple(agg[..., q, :] for q in range(5))
    return tuple(agg[:5])


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
    independently for each p.  Returns ``[P, L]``, or ``[B, P, L]`` for
    lanes (``y [B, nyb]``, ``idx`` and ``dval [B, P]``, ``agg [B, 5, L]``,
    ``ny [B]``).

    ``ny`` overrides the valid length when ``y`` lives in a zero-padded
    bucket.
    """
    if ny is None:
        ny = y.shape[-1]
    rows = agg_rows(agg)
    L = rows[0].shape[-1]
    dtype = y.dtype
    nyc = lane_col(ny, idx[..., None])                     # per lane
    head, tail = head_tail_masks(idx, nyc, L, dtype)       # [.., P, L]
    l = torch.arange(1, L + 1, device=y.device)
    y_pad = F.pad(y, (L, L))
    y_fwd = gather_clamped(y_pad, (idx + L)[..., None] + l)
    y_bwd = gather_clamped(y_pad, (idx + L)[..., None] - l)
    y_at = gather_clamped(y, idx)                          # [.., P]

    d = dval[..., None]                                    # [.., P, 1]
    e = (dval * (2.0 * y_at + dval))[..., None]            # [.., P, 1]

    sx = rows[0].unsqueeze(-2) + d * head
    sxl = rows[1].unsqueeze(-2) + d * tail
    sx2 = rows[2].unsqueeze(-2) + e * head
    sxl2 = rows[3].unsqueeze(-2) + e * tail
    sxx = rows[4].unsqueeze(-2) + d * (y_fwd * head + y_bwd * tail)

    m = (nyc - l).to(dtype)
    return acf_from_moments(sx, sxl, sx2, sxl2, sxx, m)


def acf_impact_ref(y, dval, agg_table, p0, *, L: int, measure: str = "mae"):
    """Oracle for ``kernels.acf_impact`` at full length: Algorithm-2
    impacts for all points."""
    n = y.shape[0]
    idx = torch.arange(n, dtype=torch.int32, device=y.device)
    rows = acf_after_single_delta(agg_table, y, idx, dval)  # [n, L]
    return measure_rows(rows, p0, measure)


# ---------------------------------------------------------------------------
# Eq. 9 — hypothetical ACF after a windowed (segment) delta
# ---------------------------------------------------------------------------

def _window_delta_acf(agg, dwins, abs_t, rows, *, ny: int):
    """Shared Eq. 9 core: hypothetical ACF ``[P, L]`` from per-candidate
    delta windows ``dwins [P, W]`` at global positions ``abs_t [P, W]``
    and the candidates' context rows ``rows [P, W + 2L]`` (``rows[p, L +
    j]`` the series at window position j; zero out of range).

    The five moment deltas are the reference's one contraction
    ``einsum("paw,pawl->pal", [d, d, e, e, d], basis)`` with its bilinear
    basis ``(y_fwd + d_fwd) * head + y_bwd * tail`` (that association), and
    XLA sums a contraction over the window one product at a time from +0
    (as :func:`chain_sum`), every product rounded on its own: the
    ``acf_window_impact`` kernel repeats this arithmetic bit for bit.
    """
    L = agg[0].shape[-1]
    P, W = dwins.shape
    dtype = rows.dtype
    l = torch.arange(1, L + 1, device=dwins.device)
    sums = []
    # candidates in blocks of about 2^18 (window position, lag) terms on
    # the CPU (cache-sized), 2^24 on the card (few launches; under 2 GB)
    step = max(1, (1 << (24 if rows.is_cuda else 18)) // (W * L))
    for p0 in range(0, P, step):
        dw, r, at = (v[p0:p0 + step] for v in (dwins, rows, abs_t))
        # window position first: [W, p, L]
        head = (at.T[..., None] <= ny - 1 - l).to(dtype)
        tail = (at.T[..., None] >= l).to(dtype)
        d = dw.T[..., None]
        e = (dw * (2.0 * r[:, L:L + W] + dw)).T[..., None]
        y_fwd = r[:, L + 1:].unfold(1, L, 1)[:, :W]           # y[t + l]
        y_bwd = r.unfold(1, L, 1)[:, :W].flip(-1)             # y[t - l]
        d_fwd = F.pad(dw, (0, L))[:, 1:].unfold(1, L, 1)[:, :W]  # d[j + l]
        basis = (y_fwd + d_fwd).transpose(0, 1) * head \
            + y_bwd.transpose(0, 1) * tail
        terms = torch.stack([d * head, d * tail, e * head, e * tail,
                             d * basis], dim=1)               # [W, 5, p, L]
        acc = terms[0] + 0.0
        for j in range(1, W):
            acc = acc + terms[j]
        sums.append(acc)
    table = as_table(agg)[None] + torch.cat(sums, 1).transpose(0, 1)
    m = (ny - l).to(dtype)[None, :]
    return acf_from_table(table, m)


def acf_after_window_delta_ctx(agg, y_ctx: torch.Tensor, starts: torch.Tensor,
                               dwins: torch.Tensor, *, ny: int,
                               off) -> torch.Tensor:
    """Hypothetical ACF ``[P, L]`` after applying each candidate's windowed
    delta independently (Eq. 9) against a 1-D context: ``y_ctx`` is a local
    chunk with L-point halos on each side (and W right padding), ``starts``
    local indices and ``off`` the chunk's global offset; out-of-series
    context positions must be zero."""
    L = agg[0].shape[-1]
    _, W = dwins.shape
    k = torch.arange(W + 2 * L, device=dwins.device)
    rows = y_ctx[starts[:, None] + k[None, :]]               # [P, W + 2L]
    return acf_after_window_delta_rows(agg, rows, off + starts, dwins, ny=ny)


def candidate_contexts(y: torch.Tensor, starts: torch.Tensor, *, L: int,
                       W: int) -> torch.Tensor:
    """Per-candidate ``[P, W + 2L]`` context windows for the windowed
    kernel: ``ctx[p, k] = y[starts[p] - L + k]``, zeros out of range, with
    the starts clipped into ``[0, len(y)]``."""
    y_pad = F.pad(y, (L, L + W))
    k = torch.arange(W + 2 * L, device=y.device)
    return y_pad[torch.clamp(starts[:, None], 0, y.shape[0]) + k[None, :]]


def acf_after_window_delta_rows(agg, y_rows: torch.Tensor,
                                starts_abs: torch.Tensor,
                                dwins: torch.Tensor, *, ny: int):
    """Eq. 9 hypothetical ACF ``[P, L]`` from per-candidate
    ``[P, W + 2L]`` context rows (the kernel's input layout, see
    :func:`candidate_contexts`) and global starts."""
    W = dwins.shape[1]
    j = torch.arange(W, device=dwins.device)
    abs_t = starts_abs[:, None] + j[None, :]                 # [P, W] global
    return _window_delta_acf(agg, dwins, abs_t, y_rows, ny=ny)


def acf_window_impact_ref(y_rows, dwins, starts_abs, agg_table, p0, *,
                          ny: int, measure: str = "mae"):
    """Oracle for ``kernels.acf_window_impact``: exact Eq. 9 impacts
    ``[P]`` (``measure_rows`` over :func:`acf_after_window_delta_rows`)."""
    rows = acf_after_window_delta_rows(agg_table, y_rows, starts_abs, dwins,
                                       ny=ny)
    return measure_rows(rows, p0, measure)


# ---------------------------------------------------------------------------
# Eq. 7 — lagged products (ExtractAggregates hot term), cross/halo'd form
# ---------------------------------------------------------------------------

def lag_xdot(a: torch.Tensor, b_ext: torch.Tensor, *, L: int) -> torch.Tensor:
    """``out[l-1] = sum_{t < m} a[t] * b_ext[t + l]`` for l in 1..L, as one
    ``[m] x [m, L]`` product against a shift view of ``b_ext`` (a batched
    product for lanes ``a [B, m]``, ``b_ext [B, m + L]``).

    ``b_ext`` has length ``m + L`` (the caller appends an L-point halo —
    zeros for a plain series, the next chunk's head for partitioned work).
    """
    m = a.shape[-1]
    shifted = b_ext.unfold(-1, L, 1)[..., 1:m + 1, :]      # [..., m, L]
    if a.dim() == 1:
        return a @ shifted
    return (a.unsqueeze(-2) @ shifted).squeeze(-2)


def lag_xdot_ref(a: torch.Tensor, b_ext: torch.Tensor, *,
                 L: int) -> torch.Tensor:
    """Loop oracle for :func:`lag_xdot` (one slice per lag)."""
    m = a.shape[0]
    return torch.stack([torch.sum(a * b_ext[l:l + m])
                        for l in range(1, L + 1)])


def lag_dot_ref(y: torch.Tensor, *, L: int) -> torch.Tensor:
    """Oracle for ``kernels.lag_dot``: ``sxx[l-1] = sum_t y_t y_{t+l}``."""
    return lag_xdot_ref(y, F.pad(y, (0, L)), L=L)
