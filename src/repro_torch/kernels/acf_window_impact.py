"""Exact windowed (Eq. 9) impacts with the deviation measure reduced
in-kernel (port of ``repro/kernels/acf_window_impact.py``).

For each of P candidates, the deviation between the hypothetical ACF
after its whole re-interpolated segment (an up-to-``W``-point delta window)
and ``p0``: the math behind the sequential mode's ReHeap and
``ranking_impact(rank="window")``.  Each candidate carries a ``[W + 2L]``
context row (``ref.candidate_contexts``), its ``[W]`` delta window and the
global start of the window; ``ny`` is the static valid length.
``acf_window_impact_cuda`` launches ``csrc/acf_window_impact.cu`` for card
tensors and computes the plain version, :func:`acf_window_impact_plain`,
for CPU tensors.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref as _ref
from repro_torch.kernels.acf_impact import MEASURE_CODE

_SYMBOL = {torch.float32: "acf_window_impact_f32",
           torch.float64: "acf_window_impact_f64"}


def acf_window_impact_plain(y_ctx, dwins, starts_abs, agg_table, p0, *,
                            ny: int, L: int, measure: str = "mae"):
    """Plain PyTorch version: ``ref.acf_window_impact_ref`` (the window
    summed first to last, then ``ref.measure_rows``).  Returns ``[P]``."""
    return _ref.acf_window_impact_ref(y_ctx, dwins, starts_abs, agg_table, p0,
                                      ny=ny, measure=measure)


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"acf_window_impact: {msg}")


def acf_window_impact_cuda(y_ctx, dwins, starts_abs, agg_table, p0, *,
                           ny: int, L: int, measure: str = "mae"):
    """Eq. 9 impacts ``[P]`` of the windowed deltas ``dwins [P, W]`` with
    context rows ``y_ctx [P, W + 2L]`` and global starts ``starts_abs [P]``
    against a series of valid length ``ny`` (a Python int): the CUDA kernel
    for card tensors, the plain version for CPU tensors.  Float operands
    share one dtype, float32 or float64; ``starts_abs`` is int32."""
    if y_ctx.device.type != "cuda":
        return acf_window_impact_plain(y_ctx, dwins, starts_abs, agg_table,
                                       p0, ny=ny, L=L, measure=measure)
    _check(measure in MEASURE_CODE,
           f"the kernel reduces mae/rmse/cheb, got {measure!r}")
    dev, dt = y_ctx.device, y_ctx.dtype
    _check(dt in _SYMBOL, f"y_ctx must be float32 or float64, got {dt}")
    for name, t in (("y_ctx", y_ctx), ("dwins", dwins), ("table", agg_table),
                    ("p0", p0)):
        _check(t.device == dev and t.dtype == dt and t.is_contiguous(),
               f"{name} must be a contiguous {dt} tensor on {dev}")
    _check(starts_abs.device == dev and starts_abs.dtype == torch.int32
           and starts_abs.is_contiguous(),
           f"starts_abs must be a contiguous int32 tensor on {dev}")
    P, W = dwins.shape
    _check(W >= 1 and tuple(y_ctx.shape) == (P, W + 2 * L)
           and tuple(starts_abs.shape) == (P,)
           and tuple(agg_table.shape) == (5, L) and tuple(p0.shape) == (L,),
           f"shapes y_ctx {tuple(y_ctx.shape)}, dwins {tuple(dwins.shape)}, "
           f"starts {tuple(starts_abs.shape)}, table "
           f"{tuple(agg_table.shape)}, p0 {tuple(p0.shape)} do not fit L={L}")
    out = torch.empty((P,), dtype=dt, device=dev)
    if P == 0:
        return out
    fn = _build.bind("acf_window_impact", _SYMBOL[dt], 6, 5)
    _build.check(fn(y_ctx.data_ptr(), dwins.data_ptr(), starts_abs.data_ptr(),
                    agg_table.data_ptr(), p0.data_ptr(), out.data_ptr(), P, W,
                    L, int(ny), MEASURE_CODE[measure],
                    torch.cuda.current_stream(dev).cuda_stream),
                 "acf_window_impact")
    acf_window_impact_cuda.launches += 1
    return out


acf_window_impact_cuda.launches = 0
