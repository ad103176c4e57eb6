"""The Eq. 9 aggregate map's cell sums (Def. 2): x-space delta windows
summed onto the y cells they cover, in XLA's ``segment_sum`` order.

A window ``x [..., W]`` starting at ``start [...]`` covers the
``Wy = W // kappa + 2`` cells from ``start // kappa`` on; cell ``c`` takes
the terms ``j`` with ``(start + j) // kappa - start // kappa == c``, added
left to right from +0 in the window's type, and is divided by kappa once,
correctly rounded.  That is how strict XLA runs the reference's
``jax.ops.segment_sum`` (``src/repro/kernels/ops.py:256``), so the cells
equal the JAX reference's bit for bit at every kappa.

``cell_sum_cuda`` launches the hand-written kernel of ``csrc/cell_sum.cu``
for card tensors (one launch for every window of every leading axis) and
computes the plain version, :func:`cell_sum_plain`, for CPU tensors.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import div_exact

_SYMBOL = {torch.float64: "cell_sum_f64", torch.float32: "cell_sum_f32"}


def cell_sum_plain(x: torch.Tensor, start: torch.Tensor,
                   kappa: int) -> torch.Tensor:
    """Plain PyTorch version: one gather lays each window out as
    ``[..., Wy, kappa]`` (+0 before ``start % kappa`` and past ``W``), then
    ``kappa`` vectorised adds chain each cell from +0.  A +0 term leaves the
    running sum as it is (it starts at +0, so it is never -0)."""
    W = x.shape[-1]
    Wy = W // kappa + 2
    start = torch.as_tensor(start, device=x.device)
    off = (start - (start // kappa) * kappa).to(torch.int64)
    k = torch.arange(Wy * kappa, device=x.device).reshape(Wy, kappa)
    j = k - off[..., None, None]                          # [..., Wy, kappa]
    ok = (j >= 0) & (j < W)
    lead = torch.broadcast_shapes(x.shape[:-1], off.shape)
    flat = torch.clamp(j, 0, W - 1).expand(*lead, Wy, kappa) \
        .reshape(*lead, Wy * kappa)
    vals = torch.gather(x.expand(*lead, W), -1, flat).reshape(
        *lead, Wy, kappa)
    vals = torch.where(ok, vals, torch.zeros((), dtype=x.dtype,
                                             device=x.device))
    acc = torch.zeros(vals.shape[:-1], dtype=x.dtype, device=x.device)
    for t in range(kappa):
        acc = acc + vals[..., t]
    return div_exact(acc, kappa)


def cell_sum_cuda(x: torch.Tensor, start: torch.Tensor,
                  kappa: int) -> torch.Tensor:
    """The cells ``[..., Wy]`` of the windows ``x [..., W]`` (starts
    ``start [...]``): the CUDA kernel for card tensors, the plain version
    for CPU tensors."""
    if x.device.type != "cuda":
        return cell_sum_plain(x, start, kappa)
    if x.dtype not in _SYMBOL:
        raise TypeError(f"cell_sum takes float32/float64 windows, got "
                        f"{x.dtype}")
    if x.dim() < 1 or x.shape[-1] < 1 or kappa < 1:
        raise ValueError(f"cell_sum wants windows [..., W], W >= 1, and "
                         f"kappa >= 1, got {tuple(x.shape)}, kappa {kappa}")
    W = x.shape[-1]
    Wy = W // kappa + 2
    start = torch.as_tensor(start, device=x.device)
    if start.device != x.device:
        raise ValueError(f"cell_sum: starts on {start.device}, windows on "
                         f"{x.device}")
    lead = torch.broadcast_shapes(x.shape[:-1], start.shape)
    rows = 1
    for s in lead:
        rows *= s
    out = torch.empty(*lead, Wy, dtype=x.dtype, device=x.device)
    if rows == 0:
        return out
    xs = x.expand(*lead, W).contiguous()
    st = start.to(torch.int32).expand(lead).contiguous()
    fn = _build.bind("cell_sum", _SYMBOL[x.dtype], 3, 4)
    _build.check(fn(xs.data_ptr(), st.data_ptr(), out.data_ptr(), rows, W,
                    Wy, int(kappa),
                    torch.cuda.current_stream(x.device).cuda_stream),
                 "cell_sum")
    cell_sum_cuda.launches += 1
    return out


cell_sum_cuda.launches = 0
