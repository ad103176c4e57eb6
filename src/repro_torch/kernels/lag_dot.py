"""Eq. 7 lagged products ``out[l-1] = sum_{t<n} a_t * b_ext_{t+l}``
(port of ``repro/kernels/lag_dot.py``).

``lag_dot_cuda`` launches the hand-written kernel of ``csrc/lag_dot.cu``
for card tensors and computes the plain version, :func:`lag_dot_plain`,
for CPU tensors.  The two sum in different orders (the kernel over time
tiles, the plain version left to right, as the JAX reference does), so
they agree to rounding, not bit for bit.  The self (default), cross
(``b=``) and halo'd (``halo=``, an L-point continuation of ``b`` past the
chunk end) forms all read one extended operand ``b_ext`` of length
``n + L``: the plain version builds it, the kernel reads ``b`` and
``halo`` in place.

Lanes.  The self and cross forms also take a batch of series ``a [B, n]``
(and ``b [B, n]``) and give ``[B, L]``: one launch, a grid row of time
tiles for each lane, each lane's sum the bits of its launch alone (the
counterpart of ``vmap`` over the TPU kernel, which gives it a batch grid
axis).  The halo form takes one series.
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
    """Plain PyTorch version: each lag's products ``a_t * b_ext_{t+l}``
    summed one add at a time over t, first to last (``ref.chain_sum``):
    the order in which the JAX reference's ``a @ shifted`` sums, compiled
    op by op, so the Eq. 7 tables equal its bits.  Lane by lane for the
    self form of ``a [B, n]``; card tensors are summed on the CPU."""
    if a.device.type != "cpu":
        # the oracle of the card's kernel: a chain of n adds has no fast
        # parallel form, so it runs on the CPU and comes back
        return lag_dot_plain(a.cpu(), None if b is None else b.cpu(),
                             None if halo is None else halo.cpu(),
                             L=L).to(a.device)
    if a.dim() == 2 and b is None and halo is None:
        return torch.stack([lag_dot_plain(row, L=L) for row in a])
    b_ext = extended_operand(a, b, halo, L=L)
    shifted = b_ext.unfold(-1, a.shape[-1], 1)[..., 1:L + 1, :]
    return _ref.chain_sum(a.unsqueeze(-2) * shifted)


# scratch of the kernel's cross-block sum, per (stream, dtype, size): the
# partials [B, ceil(n / tile), L] and a ticket counter a lane (0 between
# launches)
_SCRATCH: dict = {}


def _scratch(a: torch.Tensor, B: int, nblocks: int, L: int, stream: int):
    key = (a.device, stream, a.dtype, B, nblocks, L)
    if key not in _SCRATCH:
        _SCRATCH[key] = (
            torch.empty((B, nblocks, L), dtype=a.dtype, device=a.device),
            torch.zeros((B,), dtype=torch.int32, device=a.device))
    return _SCRATCH[key]


def lag_dot_cuda(a: torch.Tensor, b=None, halo=None, *,
                 L: int) -> torch.Tensor:
    """Lagged products ``[L]`` (``[B, L]`` for lanes ``a``/``b [B, n]``): the
    CUDA kernel for card tensors (one launch: ``b`` and ``halo`` are read
    in place, the zero extension and the cross-block sum happen in the
    kernel), the plain version for CPU tensors."""
    if a.device.type != "cuda":
        return lag_dot_plain(a, b, halo, L=L)
    lanes = a.dim() == 2
    if lanes and halo is not None:
        raise ValueError("lag_dot: the halo form takes one series")
    B = a.shape[0] if lanes else 1
    n = a.shape[-1] if a.dim() in (1, 2) else 0
    if a.dim() not in (1, 2) or n < 1 or L < 1 or B < 1:
        raise ValueError(f"lag_dot wants a series [n] or lanes [B, n] and "
                         f"L >= 1, got {tuple(a.shape)}, L={L}")
    if a.dtype not in _SYMBOL:
        raise TypeError(f"lag_dot takes float32/float64 operands, got "
                        f"{a.dtype}")
    a = a.contiguous()
    if b is not None:
        b = b.contiguous()
    if halo is not None:
        halo = halo[:L].to(a.dtype).contiguous()
    for name, t, size in (("b", b, tuple(a.shape)), ("halo", halo, (L,))):
        if t is None:
            continue
        if t.dtype != a.dtype:
            raise TypeError(f"lag_dot: {name} must be {a.dtype}, got "
                            f"{t.dtype}")
        if t.device != a.device or tuple(t.shape) != size:
            raise ValueError(f"lag_dot: {name} must lie on {a.device} and "
                             f"hold {size} values, got {tuple(t.shape)} on "
                             f"{t.device}")
    stream = torch.cuda.current_stream(a.device).cuda_stream
    tile = _build.library("lag_dot").lag_dot_tile()
    partials, ticket = _scratch(a, B, (n + tile - 1) // tile, L, stream)
    out = torch.empty((B, L) if lanes else (L,), dtype=a.dtype,
                      device=a.device)
    fn = _build.bind("lag_dot", _SYMBOL[a.dtype], 6, 3)
    _build.check(fn(a.data_ptr(), (a if b is None else b).data_ptr(),
                    None if halo is None else halo.data_ptr(),
                    partials.data_ptr(), ticket.data_ptr(), out.data_ptr(),
                    n, L, B, stream),
                 "lag_dot")
    lag_dot_cuda.launches += 1
    if halo is not None:
        lag_dot_cuda.halo_launches += 1
    return out


lag_dot_cuda.launches = 0
# the launches of the halo form among them (the stream's running aggregates)
lag_dot_cuda.halo_launches = 0
