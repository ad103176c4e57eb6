"""The bilinear term of the dense Eq. 10/11 update: for every lag ``l``,
``sum_t keep_t (d_t z_{t+l} + y_t d_{t+l})`` with ``z = y + d`` and
``keep_t = t <= ny - 1 - l`` (the change of ``sum_t x_t x_{t+l}`` when the
series ``y`` becomes ``y + d``).

The order is the JAX reference's CPU form (``form="roll"`` of
``repro/core/aggregates.py``'s ``apply_delta_dense``): one term a point,
``keep * (d * z_shift + y * d_shift)`` rounded op by op, summed over the
row in XLA's row-reduce order (``ref.row_sum_xla``: blocks of 32 chained
from +0, the block sums reduced by the same rule).  A masked term is a
signed zero, which leaves a sum begun at +0 as it is.

``dense_sxx_cuda`` launches the hand-written kernel of
``csrc/dense_sxx.cu`` for card tensors (one launch for every lane and lag:
a block stages one lane's tile of the row in shared memory for a group of
lags, a warp's lanes are lags, and a thread-block cluster reduces the
tiles' sums) and computes the plain version, :func:`dense_sxx_plain`, for
CPU tensors.
Both give the reference's bits, so the dense update, and with it the
rounds and the line-simplification baselines, give the same bits on the
card and the CPU, and a lane of a batch the bits of its series alone.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref as _ref

_SYMBOL = {torch.float64: "dense_sxx_f64", torch.float32: "dense_sxx_f32"}
# rows of up to 2,048 x 1,024 values: a cluster of at most 8 tiles, each
# whole third-level blocks, sums them in shared memory; a tile's staged
# segments hold the largest lag
_MAX_N = 2048 * 1024
_MAX_L = 4096
_MAX_LANES = 65535


def dense_sxx_plain(y_old: torch.Tensor, delta: torch.Tensor, ny,
                    L: int) -> torch.Tensor:
    """Plain PyTorch version, ``[..., L]``: the masked terms of every lag
    over the whole row (``ny`` an int, a 0-d tensor or one a lane), summed
    in XLA's row-reduce order."""
    nyb = y_old.shape[-1]
    dev = y_old.device
    l = torch.arange(1, L + 1, device=dev)[:, None]
    t = torch.arange(nyb, device=dev)
    nyc = torch.as_tensor(ny, device=dev)
    keep = (t <= nyc.reshape(*nyc.shape, 1, 1) - 1 - l).to(y_old.dtype)
    shift = (t + l) % nyb                                  # [L, nyb]
    z = y_old + delta
    terms = keep * (delta.unsqueeze(-2) * z[..., shift]
                    + y_old.unsqueeze(-2) * delta[..., shift])
    return _ref.row_sum_xla(terms)


def dense_sxx_cuda(y_old: torch.Tensor, delta: torch.Tensor, ny,
                   L: int) -> torch.Tensor:
    """The bilinear term ``[L]`` (``[B, L]`` for lanes ``[B, nyb]``, ``ny``
    one a lane): the CUDA kernel for card tensors, the plain version for
    CPU tensors.  ``ny`` stays on the device: the kernel reads it there."""
    if y_old.device.type != "cuda":
        return dense_sxx_plain(y_old, delta, ny, L)
    if y_old.dtype not in _SYMBOL or delta.dtype != y_old.dtype:
        raise TypeError(f"dense_sxx takes float32/float64 rows of one type, "
                        f"got {y_old.dtype} and {delta.dtype}")
    if y_old.dim() not in (1, 2) or delta.shape != y_old.shape:
        raise ValueError(f"dense_sxx wants y and delta [nyb] or [B, nyb] "
                         f"of one shape, got {tuple(y_old.shape)} and "
                         f"{tuple(delta.shape)}")
    if delta.device != y_old.device:
        raise ValueError(f"dense_sxx: delta lies on {delta.device}, y on "
                         f"{y_old.device}")
    nyb = y_old.shape[-1]
    B = y_old.shape[0] if y_old.dim() == 2 else 1
    if (not 1 <= nyb <= _MAX_N or not 1 <= B <= _MAX_LANES
            or not 1 <= L <= _MAX_L):
        raise ValueError(f"dense_sxx takes 1 <= nyb <= {_MAX_N}, at most "
                         f"{_MAX_LANES} lanes and 1 <= L <= {_MAX_L}, got "
                         f"{tuple(y_old.shape)}, L={L}")
    if isinstance(ny, torch.Tensor):
        nys = ny.to(y_old.device, torch.int32).reshape(-1).expand(B)
    else:   # a fill on the card, not a copy from the host
        nys = torch.full((B,), int(ny), dtype=torch.int32,
                         device=y_old.device)
    nys = nys.contiguous()
    y_old, delta = y_old.contiguous(), delta.contiguous()
    out = torch.empty(tuple(y_old.shape[:-1]) + (L,), dtype=y_old.dtype,
                      device=y_old.device)
    fn = _build.bind("dense_sxx", _SYMBOL[y_old.dtype], 4, 3)
    _build.check(fn(y_old.data_ptr(), delta.data_ptr(), nys.data_ptr(),
                    out.data_ptr(), nyb, L, B,
                    torch.cuda.current_stream(y_old.device).cuda_stream),
                 "dense_sxx")
    dense_sxx_cuda.launches += 1
    return out


dense_sxx_cuda.launches = 0
