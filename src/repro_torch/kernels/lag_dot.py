"""Eq. 7 lagged products ``out[l-1] = sum_{t<n} a_t * b_ext_{t+l}``
(port of ``repro/kernels/lag_dot.py``).

``lag_dot_cuda`` launches the hand-written kernel of ``csrc/lag_dot.cu``
for card tensors and computes the plain version, :func:`lag_dot_plain`,
for CPU tensors.  The self (default), cross (``b=``) and halo'd
(``halo=``, an L-point continuation of ``b`` past the chunk end) forms all
reduce to one extended operand ``b_ext`` of length ``n + L``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build
from repro_torch.kernels import ref as _ref

_SYMBOL = {torch.float64: "lag_dot_f64", torch.float32: "lag_dot_f32"}


def extended_operand(a: torch.Tensor, b=None, halo=None, *,
                     L: int) -> torch.Tensor:
    """``b_ext [n + L]``: ``b`` (default ``a``) followed by ``halo[:L]``,
    or by L zeros."""
    b_base = a if b is None else b
    if halo is not None:
        return torch.cat([b_base, halo[:L].to(b_base.dtype)])
    return F.pad(b_base, (0, L))


def lag_dot_plain(a: torch.Tensor, b=None, halo=None, *,
                  L: int) -> torch.Tensor:
    """Plain PyTorch version: one ``[n] x [n, L]`` product against a shift
    view (``ref.lag_xdot``)."""
    return _ref.lag_xdot(a, extended_operand(a, b, halo, L=L), L=L)


def lag_dot_cuda(a: torch.Tensor, b=None, halo=None, *,
                 L: int) -> torch.Tensor:
    """Lagged products ``[L]``: the CUDA kernel for card tensors, the plain
    version for CPU tensors."""
    if a.device.type != "cuda":
        return lag_dot_plain(a, b, halo, L=L)
    b_ext = extended_operand(a, b, halo, L=L).contiguous()
    n = a.shape[0]
    if a.dim() != 1 or n < 1 or L < 1:
        raise ValueError(f"lag_dot wants a 1-D series and L >= 1, got "
                         f"{tuple(a.shape)}, L={L}")
    if a.dtype not in _SYMBOL or b_ext.dtype != a.dtype:
        raise TypeError(f"lag_dot takes float32/float64 operands of one "
                        f"dtype, got {a.dtype}/{b_ext.dtype}")
    if b_ext.device != a.device or b_ext.shape[0] != n + L:
        raise ValueError("lag_dot: b/halo must lie on a's device and give "
                         f"{n + L} extended values, got {b_ext.shape[0]}")
    a = a.contiguous()
    tile = _build.library("lag_dot").lag_dot_tile()
    partials = torch.empty(((n + tile - 1) // tile, L), dtype=a.dtype,
                           device=a.device)
    out = torch.empty((L,), dtype=a.dtype, device=a.device)
    fn = _build.bind("lag_dot", _SYMBOL[a.dtype], 4, 2)
    _build.check(fn(a.data_ptr(), b_ext.data_ptr(), partials.data_ptr(),
                    out.data_ptr(), n, L,
                    torch.cuda.current_stream(a.device).cuda_stream),
                 "lag_dot")
    lag_dot_cuda.launches += 1
    return out


lag_dot_cuda.launches = 0
