"""Eq. 7 lagged products ``out[l-1] = sum_{t<n} a_t * b_ext_{t+l}``
(port of ``repro/kernels/lag_dot.py``).

``lag_dot_cuda`` launches the hand-written kernel of ``csrc/lag_dot.cu``
for card tensors and computes the plain version, :func:`lag_dot_plain`,
for CPU tensors.  The self (default), cross (``b=``) and halo'd
(``halo=``, an L-point continuation of ``b`` past the chunk end) forms all
read one extended operand ``b_ext`` of length ``n + L``: the plain version
builds it, the kernel reads ``b`` and ``halo`` in place.
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


# scratch of the kernel's cross-block sum, per (stream, dtype, size): the
# partials [ceil(n / tile), L] and the ticket counter (0 between launches)
_SCRATCH: dict = {}


def _scratch(a: torch.Tensor, nblocks: int, L: int, stream: int):
    key = (a.device, stream, a.dtype, nblocks, L)
    if key not in _SCRATCH:
        _SCRATCH[key] = (
            torch.empty((nblocks, L), dtype=a.dtype, device=a.device),
            torch.zeros((1,), dtype=torch.int32, device=a.device))
    return _SCRATCH[key]


def lag_dot_cuda(a: torch.Tensor, b=None, halo=None, *,
                 L: int) -> torch.Tensor:
    """Lagged products ``[L]``: the CUDA kernel for card tensors (one
    launch: ``b`` and ``halo`` are read in place, the zero extension and
    the cross-block sum happen in the kernel), the plain version for CPU
    tensors."""
    if a.device.type != "cuda":
        return lag_dot_plain(a, b, halo, L=L)
    n = a.shape[0] if a.dim() == 1 else 0
    if a.dim() != 1 or n < 1 or L < 1:
        raise ValueError(f"lag_dot wants a 1-D series and L >= 1, got "
                         f"{tuple(a.shape)}, L={L}")
    if a.dtype not in _SYMBOL:
        raise TypeError(f"lag_dot takes float32/float64 operands, got "
                        f"{a.dtype}")
    a = a.contiguous()
    b = a if b is None else b.contiguous()
    if halo is not None:
        halo = halo[:L].to(a.dtype).contiguous()
    for name, t, size in (("b", b, n), ("halo", halo, L)):
        if t is None:
            continue
        if t.dtype != a.dtype:
            raise TypeError(f"lag_dot: {name} must be {a.dtype}, got "
                            f"{t.dtype}")
        if t.device != a.device or tuple(t.shape) != (size,):
            raise ValueError(f"lag_dot: {name} must lie on {a.device} and "
                             f"hold {size} values, got {tuple(t.shape)} on "
                             f"{t.device}")
    stream = torch.cuda.current_stream(a.device).cuda_stream
    tile = _build.library("lag_dot").lag_dot_tile()
    partials, ticket = _scratch(a, (n + tile - 1) // tile, L, stream)
    out = torch.empty((L,), dtype=a.dtype, device=a.device)
    fn = _build.bind("lag_dot", _SYMBOL[a.dtype], 6, 2)
    _build.check(fn(a.data_ptr(), b.data_ptr(),
                    None if halo is None else halo.data_ptr(),
                    partials.data_ptr(), ticket.data_ptr(), out.data_ptr(),
                    n, L, stream),
                 "lag_dot")
    lag_dot_cuda.launches += 1
    return out


lag_dot_cuda.launches = 0
