"""GetAllImpact (paper Algorithm 2): Eq. 8 single-delta impacts with the
deviation measure reduced in-kernel (port of ``repro/kernels/acf_impact.py``).

The port's form generalises the TPU kernel to a runtime valid length
``ny`` and to the Def. 2 index map ``yi = p // kappa``, so it serves the
rounds mode's per-round ``single_impacts`` pass directly.
``acf_impact_cuda`` launches ``csrc/acf_impact.cu`` for card tensors and
computes the plain version, :func:`acf_impact_plain`, for CPU tensors.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref as _ref

MEASURE_CODE = {"mae": 0, "rmse": 1, "cheb": 2}


def acf_impact_plain(y, dval, agg_table, p0, *, L: int, measure: str = "mae",
                     ny=None, kappa: int = 1) -> torch.Tensor:
    """Plain PyTorch version: ``ref.acf_after_single_delta`` at
    ``idx // kappa`` followed by ``ref.measure_rows`` (exactly the rounds
    mode's ``single_impacts``).  Returns ``[P]``."""
    P = dval.shape[0]
    idx = torch.arange(P, dtype=torch.int32, device=y.device) // kappa
    rows = _ref.acf_after_single_delta(agg_table, y, idx, dval, ny=ny)
    return _ref.measure_rows(rows, p0, measure)


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"acf_impact: {msg}")


def acf_impact_cuda(y, dval, agg_table, p0, *, L: int, measure: str = "mae",
                    ny=None, kappa: int = 1) -> torch.Tensor:
    """Impacts ``[P]`` of a single delta ``dval[p]`` at ``y[p // kappa]``:
    the CUDA kernel for card tensors, the plain version for CPU tensors.

    ``ny`` is the valid length of the zero-padded ``y`` (default its
    length); on the card pass it as a 1-element int32 device tensor so the
    launch needs no host sync.
    """
    if y.device.type != "cuda":
        return acf_impact_plain(y, dval, agg_table, p0, L=L, measure=measure,
                                ny=ny, kappa=kappa)
    if measure not in MEASURE_CODE:
        raise ValueError(f"kernel supports mae/rmse/cheb, got {measure!r}")
    if ny is None:
        ny = torch.full((1,), y.shape[0], dtype=torch.int32, device=y.device)
    dev = y.device
    for name, t in (("y", y), ("dval", dval), ("table", agg_table),
                    ("p0", p0)):
        _check(t.device == dev and t.dtype == torch.float32
               and t.is_contiguous(),
               f"{name} must be a contiguous float32 tensor on {dev}")
    _check(isinstance(ny, torch.Tensor) and ny.device == dev
           and ny.dtype == torch.int32 and ny.numel() == 1,
           "ny must be a 1-element int32 tensor on the card")
    nyb, P = y.shape[0], dval.shape[0]
    _check(y.dim() == 1 and dval.dim() == 1 and 1 <= P <= nyb * kappa,
           f"need 1-D y and dval with P <= nyb * kappa, got "
           f"{tuple(y.shape)}, {tuple(dval.shape)}, kappa={kappa}")
    _check(tuple(agg_table.shape) == (5, L) and tuple(p0.shape) == (L,),
           f"table must be [5, {L}] and p0 [{L}]")
    out = torch.empty((P,), dtype=torch.float32, device=dev)
    fn = _build.bind("acf_impact", "acf_impact_f32", 6, 5)
    _build.check(fn(y.data_ptr(), dval.data_ptr(), agg_table.data_ptr(),
                    p0.data_ptr(), ny.data_ptr(), out.data_ptr(), P, nyb, L,
                    kappa, MEASURE_CODE[measure],
                    torch.cuda.current_stream(dev).cuda_stream),
                 "acf_impact")
    acf_impact_cuda.launches += 1
    return out


acf_impact_cuda.launches = 0
