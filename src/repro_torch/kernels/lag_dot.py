"""Eq. 7 lagged products ``out[l-1] = sum_{t<n} a_t * b_ext_{t+l}``
(port of ``repro/kernels/lag_dot.py``).

``lag_dot_cuda`` launches the hand-written kernel of ``csrc/lag_dot.cu``
for card tensors and computes the plain version, :func:`lag_dot_plain`,
for CPU tensors.  Both sum each lag's products one add at a time from +0,
first to last (the JAX reference's order), so they agree bit for bit.  The
self (default), cross (``b=``) and halo'd (``halo=``, an L-point
continuation of ``b`` past the chunk end) forms all read one extended
operand ``b_ext`` of length ``n + L``: the plain version builds it, the
kernel reads ``b`` and ``halo`` in place.

Lanes.  Every form also takes a batch of series ``a [B, n]`` (with ``b [B,
n]``, ``halo [B, L]``) and gives ``[B, L]``: one launch, a grid row a lane,
each lane's sum the bits of its launch alone (the counterpart of ``vmap``
over the TPU kernel, which gives it a batch grid axis).  The partitioned
mode's halo'd contributions of T partitions are one launch.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build
from repro_torch.kernels import ref as _ref

_SYMBOL = {torch.float64: "lag_dot_f64", torch.float32: "lag_dot_f32"}


def extended_operand(a: torch.Tensor, b=None, halo=None, *,
                     L: int) -> torch.Tensor:
    """``b_ext [..., n + L]``: ``b`` (default ``a``) followed by
    ``halo[..., :L]``, or by L zeros."""
    b_base = a if b is None else b
    if halo is not None:
        return torch.cat([b_base, halo[..., :L].to(b_base.dtype)], dim=-1)
    return F.pad(b_base, (0, L))


def lag_dot_plain(a: torch.Tensor, b=None, halo=None, *,
                  L: int) -> torch.Tensor:
    """Plain PyTorch version: each lag's products ``a_t * b_ext_{t+l}``
    summed one add at a time over t, first to last (``ref.chain_sum``):
    the order in which the JAX reference's ``a @ shifted`` sums, compiled
    op by op (vmapped too), so the Eq. 7 tables equal its bits.  Lane by
    lane for ``a [B, n]``; card tensors are summed on the CPU."""
    if a.device.type != "cpu":
        # the oracle of the card's kernel: a chain of n adds has no fast
        # parallel form, so it runs on the CPU and comes back
        return lag_dot_plain(a.cpu(), None if b is None else b.cpu(),
                             None if halo is None else halo.cpu(),
                             L=L).to(a.device)
    if a.dim() == 2:
        return torch.stack([lag_dot_plain(
            a[k], None if b is None else b[k],
            None if halo is None else halo[k], L=L) for k in range(a.shape[0])])
    b_ext = extended_operand(a, b, halo, L=L)
    shifted = b_ext.unfold(-1, a.shape[-1], 1)[..., 1:L + 1, :]
    return _ref.chain_sum(a.unsqueeze(-2) * shifted)


def lag_dot_cuda(a: torch.Tensor, b=None, halo=None, *,
                 L: int) -> torch.Tensor:
    """Lagged products ``[L]`` (``[B, L]`` for lanes ``a [B, n]``, with
    ``b [B, n]`` and ``halo [B, L]``): the CUDA kernel for card tensors
    (one launch: ``b`` and ``halo`` are read in place and the zero
    extension happens in the kernel), the plain version for CPU tensors."""
    if a.device.type != "cuda":
        return lag_dot_plain(a, b, halo, L=L)
    lanes = a.dim() == 2
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
        halo = halo[..., :L].to(a.dtype).contiguous()
    lead = tuple(a.shape[:-1])
    for name, t, size in (("b", b, tuple(a.shape)), ("halo", halo,
                                                      lead + (L,))):
        if t is None:
            continue
        if t.dtype != a.dtype:
            raise TypeError(f"lag_dot: {name} must be {a.dtype}, got "
                            f"{t.dtype}")
        if t.device != a.device or tuple(t.shape) != size:
            raise ValueError(f"lag_dot: {name} must lie on {a.device} and "
                             f"hold {size} values, got {tuple(t.shape)} on "
                             f"{t.device}")
    out = torch.empty(lead + (L,), dtype=a.dtype, device=a.device)
    fn = _build.bind("lag_dot", _SYMBOL[a.dtype], 4, 3)
    _build.check(fn(a.data_ptr(), (a if b is None else b).data_ptr(),
                    None if halo is None else halo.data_ptr(),
                    out.data_ptr(), n, L, B,
                    torch.cuda.current_stream(a.device).cuda_stream),
                 "lag_dot")
    lag_dot_cuda.launches += 1
    if halo is not None:
        lag_dot_cuda.halo_launches += 1
    return out


lag_dot_cuda.launches = 0
# the launches of the halo form among them (the stream's running aggregates
# and the partitioned mode's contributions)
lag_dot_cuda.halo_launches = 0
