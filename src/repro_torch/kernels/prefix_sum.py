"""Inclusive prefix sums over the last axis in one fixed order: left to
right, one add at a time, in float64 (the cumulative sums of the dense
Eq. 10/11 update and of the Eq. 7 moments).

``prefix_sum_cuda`` launches the hand-written kernel of
``csrc/prefix_sum.cu`` for card tensors (one launch for every row, a block
a row) and computes the plain version, :func:`prefix_sum_plain`
(``torch.cumsum``, which sums in that order on the CPU), for CPU tensors.
On the card ``torch.cumsum``'s order depends on the number of rows, so a
lane of a batch would not keep the bits of the same series alone; the
kernel's order does not, and equals the CPU's.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

_SYMBOL = {torch.float64: "prefix_sum_f64", torch.float32: "prefix_sum_f32"}


def prefix_sum_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: ``torch.cumsum`` over the last axis (left to
    right in float64 on the CPU; of unspecified order on the card)."""
    return torch.cumsum(x, dim=-1)


def prefix_sum_cuda(x: torch.Tensor) -> torch.Tensor:
    """Prefix sums of ``x [..., n]`` over the last axis: the CUDA kernel for
    card tensors, the plain version for CPU tensors."""
    if x.device.type != "cuda":
        return prefix_sum_plain(x)
    if x.dtype not in _SYMBOL:
        raise TypeError(f"prefix_sum takes float32/float64 rows, got "
                        f"{x.dtype}")
    if x.dim() < 1 or x.shape[-1] < 1 or x.numel() == 0:
        raise ValueError(f"prefix_sum wants rows [..., n], n >= 1, got "
                         f"{tuple(x.shape)}")
    x = x.contiguous()
    out = torch.empty_like(x)
    n = x.shape[-1]
    stream = torch.cuda.current_stream(x.device).cuda_stream
    fn = _build.bind("prefix_sum", _SYMBOL[x.dtype], 2, 2)
    _build.check(fn(x.data_ptr(), out.data_ptr(), n, x.numel() // n, stream),
                 "prefix_sum")
    prefix_sum_cuda.launches += 1
    return out


prefix_sum_cuda.launches = 0
