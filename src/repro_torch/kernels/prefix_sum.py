"""Inclusive prefix sums over the last axis in XLA's cumsum order (the
cumulative sums of the dense Eq. 10/11 update and of the Eq. 7 moments).

The order is a blocked scan of base 16, recursive: each 16-value group of
the row (the last one padded with zeros) is summed one add at a time from
+0; the groups' totals are scanned the same way, level by level, up to a
level of at most 16 values; then every partial gets the sum of the groups
before its own at the level above (group 0 gets +0).  ``jax.numpy.cumsum``
takes exactly this order (XLA's CPU backend rewrites its reduce_window into
it), so the port's prefix sums equal the JAX reference's bit for bit.  The
adds are in the row's own type: a float32 row sums in float32, as XLA's
does (not in float64, as ``torch.cumsum`` does on the CPU).

``prefix_sum_cuda`` launches the hand-written kernel of
``csrc/prefix_sum.cu`` for card tensors (one launch for every row, a
thread-block cluster a row) and computes the plain version,
:func:`prefix_sum_plain`, for CPU tensors.  The order is fixed by the row's
length alone, so the card's sums equal the CPU's and a lane of a batch keeps
the bits of the same series alone (``torch.cumsum`` on the card does
neither).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build

_SYMBOL = {torch.float64: "prefix_sum_f64", torch.float32: "prefix_sum_f32"}
_BASE = 16
# the kernel's tile (16^3 values: levels 0-2 of the scan), its largest
# cluster (the portable size) and its longest row (4,096 tiles)
_TILE = 4096
_MAX_CLUSTER = 8
_MAX_N = 4096 * _TILE


def _chain(v: torch.Tensor) -> torch.Tensor:
    """Partial sums along the last axis (at most 16 values), one add at a
    time from +0, in ``v``'s type."""
    acc = torch.zeros_like(v[..., 0])
    out = []
    for j in range(v.shape[-1]):
        acc = acc + v[..., j]
        out.append(acc)
    return torch.stack(out, -1)


def prefix_sum_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: XLA's order, level by level (16 column adds,
    a pad and a reshape a level, then one add a level on the way down)."""
    n = x.shape[-1]
    if n == 0:
        return x.clone()
    if n <= _BASE:
        return _chain(x)
    m = -(-n // _BASE)
    inb = _chain(F.pad(x, (0, _BASE * m - n)).reshape(*x.shape[:-1], m,
                                                       _BASE))
    before = F.pad(prefix_sum_plain(inb[..., -1])[..., :-1], (1, 0))
    return (inb + before[..., None]).reshape(*x.shape[:-1], _BASE * m)[..., :n]


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
    n = x.shape[-1]
    rows = x.numel() // n
    if n > _MAX_N or rows > 65535:
        raise ValueError(f"prefix_sum takes rows of at most {_MAX_N} values "
                         f"and at most 65,535 rows, got {tuple(x.shape)}")
    x = x.contiguous()
    out = torch.empty_like(x)
    cluster = min(_MAX_CLUSTER, -(-n // _TILE))
    stream = torch.cuda.current_stream(x.device).cuda_stream
    fn = _build.bind("prefix_sum", _SYMBOL[x.dtype], 2, 3)
    _build.check(fn(x.data_ptr(), out.data_ptr(), n, rows, cluster, stream),
                 "prefix_sum")
    prefix_sum_cuda.launches += 1
    return out


prefix_sum_cuda.launches = 0
