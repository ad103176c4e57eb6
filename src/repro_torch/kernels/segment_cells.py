"""The Eq. 9 delta windows of removing candidate points, from each
segment's endpoints to its cells on the target series (Def. 2), in one
launch.

For candidates ``i`` of the reconstruction ``xr [..., n]`` with alive
neighbours ``prev``, ``nxt [..., n]`` (int32), this is
``x_window_to_y(cfg, *segment_deltas(xr, prev, nxt, i, W)[:2])`` and the
span, as strict XLA computes the reference's pair
(``src/repro/core/aggregates.py:298`` and ``src/repro/kernels/ops.py:256``):
the line's multiply-add rounded once (ROADMAP C19), and at kappa > 1 each
cell added left to right from +0 and divided by kappa once (C20).  Returns
``(cells [..., W or Wy], ystart [...], span [...])``, with ``Wy = W //
kappa + 2`` and ``ystart = start // kappa`` at kappa > 1, ``cells`` the
delta window and ``ystart = start`` at kappa 1; ``x_window=True`` appends
the x-space window and its start ``(dwin [..., W], start [...])`` (at
kappa 1 the cells and ``ystart`` again).

``segment_cells_cuda`` launches the hand-written kernel of
``csrc/segment_cells.cu`` for card tensors and computes the plain version,
:func:`segment_cells_plain` (the pair the reference composes), for CPU
tensors.  Both give the same bits.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.cell_sum import cell_sum_plain

_SUFFIX = {torch.float64: "f64", torch.float32: "f32"}
_INDEX = {torch.int32: "i32", torch.int64: "i64"}


def segment_cells_plain(xr: torch.Tensor, prev: torch.Tensor,
                        nxt: torch.Tensor, i, W: int, kappa: int,
                        x_window: bool = False) -> tuple:
    """Plain version: ``core.aggregates.segment_deltas``, then at kappa > 1
    ``cell_sum_plain`` and ``start // kappa``."""
    from repro_torch.core.aggregates import segment_deltas  # core imports ops
    dwin, start, span = segment_deltas(xr, prev, nxt, torch.as_tensor(
        i, device=xr.device), W)
    if kappa == 1:
        out = (dwin, start, span)
    else:
        out = (cell_sum_plain(dwin, start, kappa), start // kappa, span)
    return out + (dwin, start) if x_window else out


def _lanes(xr: torch.Tensor, i: torch.Tensor):
    """``(i, rows, K, cand_stride, out_lead)``: the lanes of ``xr [*lead,
    n]`` and the candidates a lane, as ``ref.take`` lays ``i`` against
    them (a lane's candidates contiguous; stride 0 for one row of
    candidates for every lane)."""
    if i.dim() > 0 and i.stride(-1) != 1:
        i = i.contiguous()
    if xr.dim() == 1:
        return i.contiguous(), 1, i.numel(), 0, tuple(i.shape)
    lead = tuple(xr.shape[:-1])
    rows = xr[..., 0].numel()
    if i.dim() == 1:
        return i, rows, i.shape[0], 0, lead + (i.shape[0],)
    if xr.dim() == 2 and i.dim() == 2 and i.shape[0] in (1, rows):
        stride = i.stride(0) if i.shape[0] == rows else 0
        return i, rows, i.shape[1], stride, lead + (i.shape[1],)
    raise ValueError(f"segment_cells: candidates {tuple(i.shape)} do not "
                     f"index lanes {lead}")


def segment_cells_cuda(xr: torch.Tensor, prev: torch.Tensor,
                       nxt: torch.Tensor, i, W: int, kappa: int,
                       x_window: bool = False) -> tuple:
    """The cells of the candidates ``i``' delta windows (see the module
    docstring): the CUDA kernel for card tensors (float32 or float64, one
    launch), the plain version for CPU tensors."""
    if xr.device.type != "cuda":
        return segment_cells_plain(xr, prev, nxt, i, W, kappa, x_window)
    if xr.dtype not in _SUFFIX:
        raise TypeError(f"segment_cells takes a float32/float64 "
                        f"reconstruction, got {xr.dtype}")
    i = torch.as_tensor(i, device=xr.device)
    if i.dtype not in _INDEX or prev.dtype != torch.int32 \
            or nxt.dtype != torch.int32:
        raise TypeError(f"segment_cells wants int32 neighbours and int32 or "
                        f"int64 candidates, got {prev.dtype}, {nxt.dtype}, "
                        f"{i.dtype}")
    if prev.shape != xr.shape or nxt.shape != xr.shape:
        raise ValueError(f"segment_cells: neighbours {tuple(prev.shape)}, "
                         f"{tuple(nxt.shape)} for xr {tuple(xr.shape)}")
    if xr.dim() < 1 or xr.shape[-1] < 1 or W < 1 or kappa < 1:
        raise ValueError(f"segment_cells wants xr [..., n], n >= 1, W >= 1 "
                         f"and kappa >= 1, got {tuple(xr.shape)}, W {W}, "
                         f"kappa {kappa}")
    i, rows, K, stride, lead = _lanes(xr, i)
    if rows * K >= 2 ** 31:
        raise ValueError(f"segment_cells takes fewer than 2^31 windows a "
                         f"launch, got {rows} x {K}")
    n = xr.shape[-1]
    Wy = W // kappa + 2 if kappa > 1 else W
    dev = xr.device
    cells = torch.empty(*lead, Wy, dtype=xr.dtype, device=dev)
    ystart = torch.empty(lead, dtype=torch.int32, device=dev)
    span = torch.empty(lead, dtype=torch.int32, device=dev)
    want_x = x_window and kappa > 1
    dwin = torch.empty(*lead, W, dtype=xr.dtype, device=dev) \
        if want_x else None
    start = torch.empty(lead, dtype=torch.int32, device=dev) \
        if want_x else None
    if rows * K > 0:
        xr, prev, nxt = xr.contiguous(), prev.contiguous(), nxt.contiguous()
        fn = _build.bind("segment_cells", f"segment_cells_{_SUFFIX[xr.dtype]}"
                         f"_{_INDEX[i.dtype]}", 9, 6)
        _build.check(fn(
            xr.data_ptr(), prev.data_ptr(), nxt.data_ptr(), i.data_ptr(),
            cells.data_ptr(), ystart.data_ptr(), span.data_ptr(),
            dwin.data_ptr() if want_x else None,
            start.data_ptr() if want_x else None, rows, K, stride, n, W,
            int(kappa), torch.cuda.current_stream(dev).cuda_stream),
            "segment_cells")
        segment_cells_cuda.launches += 1
    out = (cells, ystart, span)
    if not x_window:
        return out
    return out + ((dwin, start) if want_x else (cells, ystart))


segment_cells_cuda.launches = 0
