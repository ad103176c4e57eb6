"""GetAllImpact (paper Algorithm 2): Eq. 8 single-delta impacts with the
deviation measure reduced in-kernel (port of ``repro/kernels/acf_impact.py``).

The port's form generalises the TPU kernel to a runtime valid length
``ny`` and to the Def. 2 index map ``yi = p // kappa``, so it serves the
rounds mode's per-round ``single_impacts`` pass (float32) and the
sequential mode's ``init_impacts`` (float64) directly.
``acf_impact_cuda`` launches ``csrc/acf_impact.cu`` for card tensors and
computes the plain version, :func:`acf_impact_plain`, for CPU tensors.
Both take a batch of series on a leading lane axis (``y [B, nyb]``,
``dval [B, P]``, table ``[B, 5, L]``, ``p0 [B, L]``, ``ny [B]`` →
``[B, P]``): one launch for every lane, each lane's impacts the bits of
its launch alone.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref as _ref

MEASURE_CODE = {"mae": 0, "rmse": 1, "cheb": 2}
_SYMBOL = {torch.float32: "acf_impact_f32", torch.float64: "acf_impact_f64"}


def acf_impact_plain(y, dval, agg_table, p0, *, L: int, measure: str = "mae",
                     ny=None, kappa: int = 1) -> torch.Tensor:
    """Plain PyTorch version: ``ref.acf_after_single_delta`` at
    ``idx // kappa`` followed by ``ref.measure_rows`` (exactly the rounds
    mode's ``single_impacts``).  Returns ``[P]`` (``[B, P]`` for
    lanes)."""
    P = dval.shape[-1]
    idx = torch.arange(P, dtype=torch.int32, device=y.device) // kappa
    if y.dim() == 2:
        idx = idx[None]
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
    length); on the card pass it as an int32 device tensor, one element a
    lane, so the launch needs no host sync.  Every float operand has
    ``y``'s dtype, float32 or float64.
    """
    if y.device.type != "cuda":
        return acf_impact_plain(y, dval, agg_table, p0, L=L, measure=measure,
                                ny=ny, kappa=kappa)
    if measure not in MEASURE_CODE:
        raise ValueError(f"kernel supports mae/rmse/cheb, got {measure!r}")
    lanes = y.dim() == 2
    B = y.shape[0] if lanes else 1
    if ny is None:
        ny = torch.full((B,), y.shape[-1], dtype=torch.int32, device=y.device)
    dev, dt = y.device, y.dtype
    _check(dt in _SYMBOL, f"y must be float32 or float64, got {dt}")
    for name, t in (("y", y), ("dval", dval), ("table", agg_table),
                    ("p0", p0)):
        _check(t.device == dev and t.dtype == dt and t.is_contiguous(),
               f"{name} must be a contiguous {dt} tensor on {dev}")
    _check(isinstance(ny, torch.Tensor) and ny.device == dev
           and ny.dtype == torch.int32 and ny.numel() == B
           and ny.is_contiguous(),
           f"ny must be {B} int32 value(s) on the card, one a lane")
    nyb, P = y.shape[-1], dval.shape[-1]
    lead = (B,) if lanes else ()
    _check(y.dim() in (1, 2) and tuple(dval.shape) == lead + (P,)
           and 1 <= P <= nyb * kappa and B >= 1,
           f"need y [nyb] and dval [P] (or [B, nyb] and [B, P]) with "
           f"P <= nyb * kappa, got {tuple(y.shape)}, {tuple(dval.shape)}, "
           f"kappa={kappa}")
    _check(tuple(agg_table.shape) == lead + (5, L)
           and tuple(p0.shape) == lead + (L,),
           f"table must be {list(lead + (5, L))} and p0 {list(lead + (L,))}")
    out = torch.empty(lead + (P,), dtype=dt, device=dev)
    fn = _build.bind("acf_impact", _SYMBOL[dt], 6, 6)
    _build.check(fn(y.data_ptr(), dval.data_ptr(), agg_table.data_ptr(),
                    p0.data_ptr(), ny.data_ptr(), out.data_ptr(), P, nyb, L,
                    kappa, MEASURE_CODE[measure], B,
                    torch.cuda.current_stream(dev).cuda_stream),
                 "acf_impact")
    acf_impact_cuda.launches += 1
    return out


acf_impact_cuda.launches = 0
