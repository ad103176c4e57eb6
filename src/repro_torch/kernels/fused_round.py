"""Eq. 9 tier rows of the rounds mode — the window-rows half of
``repro/kernels/fused_round.py``.

Each rounds-mode tier ranks up to ``cap`` multi-point segments exactly:
one hypothetical ACF row per candidate delta window, applied alone.  The
plain form (:func:`window_acf_rows` over :func:`_moment_deltas`) relies on
the padded-bucket discipline — ``y`` is zero beyond ``ny`` and before 0,
and deltas only touch valid positions — so the head/tail masks are
contiguous cuts of the window axis and the bilinear term needs none.
``window_rows_cuda`` gives what the rounds mode's tier ranking reads: each
row reduced to its deviation from ``p0``.  It launches
``csrc/window_rows.cu`` for card tensors and computes its plain version,
``ref.measure_rows`` over :func:`window_acf_rows`, for CPU tensors (the
backend choice itself sits beside the single-delta one in
``core/cameo.py``).  The prefix-scan half (``prefix_devs``/
``greedy_feasible``, ``select="scan"``) is not ported yet.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build
from repro_torch.kernels import ref as _ref
from repro_torch.kernels.acf_impact import MEASURE_CODE


def _prefix_in_order(x):
    """``[K, W + 1]`` exclusive prefix sums of ``x [K, W]``, one term at a
    time (``torch.cumsum``'s order is not specified; see
    ``ref.sum_in_order``)."""
    cols = [torch.zeros_like(x[:, 0])]
    for j in range(x.shape[1]):
        cols.append(cols[-1] + x[:, j])
    return torch.stack(cols, dim=1)


def _head_tail_sums(d, e, ystarts, ny, L):
    K, Wy = d.shape
    l = torch.arange(1, L + 1, device=d.device)
    # head keeps abs_t <= ny-1-l  <=>  j < ny - l - s   (contiguous prefix);
    # tail keeps abs_t >= l       <=>  j >= l - s       (contiguous suffix).
    cdz = _prefix_in_order(d)
    cez = _prefix_in_order(e)
    c_head = torch.clamp(ny - l[None, :] - ystarts[:, None], 0, Wy).long()
    c_tail = torch.clamp(l[None, :] - ystarts[:, None], 0, Wy).long()
    dsx = torch.gather(cdz, 1, c_head)
    dsx2 = torch.gather(cez, 1, c_head)
    dsxl = cdz[:, -1:] - torch.gather(cdz, 1, c_tail)
    dsxl2 = cez[:, -1:] - torch.gather(cez, 1, c_tail)
    return dsx, dsxl, dsx2, dsxl2


def _moment_deltas(d, ctx, ystarts, ny, *, L: int):
    """Five per-lag aggregate deltas ``[K, 5, L]`` for independent windowed
    deltas ``d [K, Wy]`` given their series context ``ctx [K, Wy + 2L]``
    (``ctx[k, i] = y[start_k - L + i]``).

    The bilinear term reads the lag-shifted context through shift views
    (``unfold``) for all lags at once and sums over the window in order
    (the kernel's order, see ``ref.sum_in_order``).
    """
    K, Wy = d.shape
    e = d * (2.0 * ctx[:, L:L + Wy] + d)
    dsx, dsxl, dsx2, dsxl2 = _head_tail_sums(d, e, ystarts, ny, L)
    win = ctx.unfold(1, Wy, 1)                      # [K, 2L+1, Wy]: ctx[s:s+Wy]
    fwd = win[:, L + 1:]                            # s = L + l
    bwd = win[:, :L].flip(1)                        # s = L - l
    d_f = F.pad(d, (0, L)).unfold(1, Wy, 1)[:, 1:]  # d[j + l], zero past Wy
    G = (fwd + bwd) + d_f                           # [K, L, Wy]
    dsxx = _ref.sum_in_order(d[:, None, :] * G)
    return torch.stack([dsx, dsxl, dsx2, dsxl2, dsxx], dim=1)  # [K, 5, L]


def _moment_deltas_ref(d, ctx, ystarts, ny, *, L: int):
    """Loop oracle for :func:`_moment_deltas`: the L-unrolled
    slice-multiply-sum form of the bilinear term."""
    K, Wy = d.shape
    e = d * (2.0 * ctx[:, L:L + Wy] + d)
    dsx, dsxl, dsx2, dsxl2 = _head_tail_sums(d, e, ystarts, ny, L)
    d_pad = F.pad(d, (0, L))
    dsxx = torch.stack(
        [torch.sum(d * (ctx[:, L + lag:L + lag + Wy]
                        + ctx[:, L - lag:L - lag + Wy]
                        + d_pad[:, lag:lag + Wy]), dim=1)
         for lag in range(1, L + 1)], dim=1)
    return torch.stack([dsx, dsxl, dsx2, dsxl2, dsxx], dim=1)  # [K, 5, L]


def candidate_context(y, ystarts, *, L: int, Wy: int):
    """Per-candidate ``[K, Wy + 2L]`` context of the zero-padded ``y`` at
    the start clipped into ``[0, nyb)``, zeros out of range."""
    nyb = y.shape[0]
    starts = torch.clamp(ystarts, 0, nyb - 1)
    kk = torch.arange(Wy + 2 * L, device=y.device)
    return F.pad(y, (L, L + Wy))[starts[:, None] + kk[None, :]]


def solo_moment_rows(y, dyws, ystarts, ny, *, L: int):
    """Aggregate-delta rows ``[K, 5, L]`` for each candidate applied alone
    on the current reconstruction (context gathered from ``y`` only)."""
    ctx = candidate_context(y, ystarts, L=L, Wy=dyws.shape[1])
    return _moment_deltas(dyws.to(y.dtype), ctx, ystarts, ny, L=L)


def window_acf_rows(y, dyws, ystarts, agg_table, ny, *, L: int):
    """Independent per-candidate Eq. 9 ACF rows ``[K, L]`` (the plain
    version of the ``window_rows`` kernel)."""
    dt = y.dtype
    cum = solo_moment_rows(y, dyws, ystarts, ny, L=L) + agg_table[None]
    l = torch.arange(1, L + 1, device=y.device)
    m = (ny - l).to(dt)[None, :]
    return _ref.acf_from_moments(cum[:, 0], cum[:, 1], cum[:, 2],
                                 cum[:, 3], cum[:, 4], m)


def window_rows_plain(y, dyws, ystarts, agg_table, ny, p0, *, L: int,
                      measure: str):
    """Plain version of the ``window_rows`` kernel: the rows' deviations
    from ``p0`` ``[K]`` (``ref.measure_rows`` over
    :func:`window_acf_rows`)."""
    rows = window_acf_rows(y, dyws, ystarts, agg_table, ny, L=L)
    return _ref.measure_rows(rows, p0, measure)


def window_rows_cuda(y, dyws, ystarts, agg_table, ny, p0, *, L: int,
                     measure: str):
    """Eq. 9 ranking impacts ``[K]``: each candidate's ACF row reduced to
    its deviation from ``p0`` under ``measure`` (mae/rmse/cheb).  The CUDA
    kernel for card tensors, the plain version for CPU tensors.

    On the card every operand is float32 (``ystarts`` int32) and ``ny`` a
    1-element int32 device tensor, so the launch needs no host sync.
    """
    if y.device.type != "cuda":
        return window_rows_plain(y, dyws, ystarts, agg_table, ny, p0, L=L,
                                 measure=measure)
    dev = y.device
    if measure not in MEASURE_CODE:
        raise ValueError(f"window_rows reduces mae/rmse/cheb, got {measure!r}")
    for name, t in (("y", y), ("dyws", dyws), ("table", agg_table),
                    ("p0", p0)):
        if not (isinstance(t, torch.Tensor) and t.device == dev
                and t.dtype == torch.float32 and t.is_contiguous()):
            raise ValueError(f"window_rows: {name} must be a contiguous "
                             f"float32 tensor on {dev}")
    for name, t in (("ystarts", ystarts), ("ny", ny)):
        if not (isinstance(t, torch.Tensor) and t.device == dev
                and t.dtype == torch.int32 and t.is_contiguous()):
            raise ValueError(f"window_rows: {name} must be a contiguous "
                             f"int32 tensor on {dev}")
    K, Wy = dyws.shape
    if (y.dim() != 1 or tuple(ystarts.shape) != (K,) or ny.numel() != 1
            or tuple(agg_table.shape) != (5, L) or Wy < 1
            or tuple(p0.shape) != (L,)):
        raise ValueError(
            f"window_rows: shapes y {tuple(y.shape)}, dyws {tuple(dyws.shape)}"
            f", ystarts {tuple(ystarts.shape)}, table {tuple(agg_table.shape)}"
            f", p0 {tuple(p0.shape)}, ny {tuple(ny.shape)} do not fit L={L}")
    out = torch.empty((K,), dtype=torch.float32, device=dev)
    if K == 0:
        return out
    fn = _build.bind("window_rows", "window_rows_f32", 7, 5)
    _build.check(fn(dyws.data_ptr(), ystarts.data_ptr(), y.data_ptr(),
                    agg_table.data_ptr(), ny.data_ptr(), p0.data_ptr(),
                    out.data_ptr(), K, Wy, y.shape[0], L,
                    MEASURE_CODE[measure],
                    torch.cuda.current_stream(dev).cuda_stream),
                 "window_rows")
    window_rows_cuda.launches += 1
    return out


window_rows_cuda.launches = 0
