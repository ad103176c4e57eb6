"""The greedy segmentation scans of the PMC and Swing baselines (the
counterparts of the two ``jax.lax.scan`` calls of
``repro/baselines/functional.py``).

Both walk one series point by point and reset their state where a
segment breaks:

* ``"pmc"`` — PMC-Mean: the running ``(lo, hi)`` of the open segment; a
  point breaks it where ``(max(hi, x) - min(lo, x)) > 2 err``, and the new
  segment starts at that point.  Output: the break flags ``[n]``.
* ``"swing"`` — the Swing filter: an anchor ``(t0, x0)`` and a slope cone
  ``[l, u]``; a point breaks the segment where the cone, narrowed by the
  point's error band, closes, and the new segment is anchored at the
  previous point's approximation.  Output: the scan's per-step outputs
  ``(brk, t0, x0, u, l)``, each ``[n]``.

Every operation rounds on its own, in the reference's order and
association (``(x + err - x0) / dt``, ``x0 + 0.5 (u + l) (t - 1 - t0)``),
so the outputs equal the reference's scan compiled op by op bit for bit.

``segment_scan_cuda`` launches the hand-written kernel of
``csrc/segment_scan.cu`` for card tensors (a warp settles a segment a
step: 32 points at once, the state closed by a prefix min and max across
the warp, the break found by a ballot) and computes the plain version,
:func:`segment_scan_plain`, for CPU tensors.  The plain version is the
same walk in Python, one step a point, with every operation in the
series' own type: the step is a dozen scalar operations, which a loop of
PyTorch tensor operations would round alike at ~1 µs each, and no PyTorch
operation computes a scan that resets.  NaN values are not supported.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import _build

MODES = ("pmc", "swing")
_SUFFIX = {torch.float64: "f64", torch.float32: "f32"}
# one series a launch; a step's last point index is an int
_MAX_N = 2 ** 31 - 64


def _scalar_type(dtype: torch.dtype):
    """The Python scalar type whose arithmetic rounds as ``dtype`` does:
    float64 is Python's float; float32 takes numpy's float32 scalars."""
    if dtype == torch.float64:
        return float
    if dtype == torch.float32:
        return np.float32
    raise TypeError(f"segment_scan takes float32/float64 series, got {dtype}")


def _pmc_walk(xs: list, err, f) -> list:
    err2 = f(2.0) * f(err)
    lo, hi = f(np.inf), f(-np.inf)
    brks = []
    for xi in xs:
        nlo = xi if xi < lo else lo
        nhi = xi if xi > hi else hi
        brk = (nhi - nlo) > err2
        if brk:
            lo = hi = xi
        else:
            lo, hi = nlo, nhi
        brks.append(brk)
    return brks


def _swing_walk(xs: list, err, f):
    err = f(err)
    one, half = f(1.0), f(0.5)
    t0, x0, u, l = f(0.0), xs[0], f(np.inf), f(-np.inf)
    out = ([], [], [], [], [])
    for i, xi in enumerate(xs):
        t = f(i)
        dt = t - t0
        dt = dt if dt > one else one
        s_hi = (xi + err - x0) / dt
        s_lo = (xi - err - x0) / dt
        nu = s_hi if s_hi < u else u
        nl = s_lo if s_lo > l else l
        brk = t0 != t and nl > nu
        if brk:
            # the new segment's anchor: the previous point's approximation
            x0 = x0 + half * (u + l) * (t - one - t0)
            t0 = t - one
            dt = t - t0
            dt = dt if dt > one else one
            u = (xi + err - x0) / dt
            l = (xi - err - x0) / dt
        else:
            u, l = nu, nl
        for seq, v in zip(out, (brk, t0, x0, u, l)):
            seq.append(v)
    return out


def segment_scan_plain(x: torch.Tensor, err: float, mode: str) -> tuple:
    """Plain version: the reference's scan, one step a point in Python, in
    ``x``'s type.  ``"pmc"`` gives ``(brk,)``, ``"swing"`` ``(brk, t0, x0,
    u, l)``; flags are bool, the rest ``x``'s type, all on ``x``'s
    device."""
    if mode not in MODES:
        raise ValueError(f"unknown segment_scan mode {mode!r}; have {MODES}")
    if x.dim() != 1 or x.shape[0] < 1:
        raise ValueError(f"segment_scan wants one series [n], n >= 1, got "
                         f"{tuple(x.shape)}")
    f = _scalar_type(x.dtype)
    host = x.detach().cpu().numpy()
    xs = host.tolist() if f is float else list(host)
    if mode == "pmc":
        outs = (_pmc_walk(xs, err, f),)
    else:
        outs = _swing_walk(xs, err, f)
    brk = torch.tensor(outs[0], dtype=torch.bool)
    rest = [torch.from_numpy(np.asarray(v, dtype=host.dtype))
            for v in outs[1:]]
    return tuple(t.to(x.device) for t in (brk, *rest))


def segment_scan_cuda(x: torch.Tensor, err: float, mode: str) -> tuple:
    """The scan of ``mode`` over the series ``x [n]``: the CUDA kernel for
    card tensors (float64 or float32, one launch), the plain version for CPU
    tensors.
    Returns what :func:`segment_scan_plain` returns."""
    if x.device.type != "cuda":
        return segment_scan_plain(x, err, mode)
    if mode not in MODES:
        raise ValueError(f"unknown segment_scan mode {mode!r}; have {MODES}")
    if x.dtype not in _SUFFIX:
        raise TypeError(f"segment_scan's kernel takes a float32/float64 "
                        f"series, got {x.dtype}")
    if x.dim() != 1 or not 1 <= x.shape[0] <= _MAX_N:
        raise ValueError(f"segment_scan wants one series [n], 1 <= n <= "
                         f"{_MAX_N}, got {tuple(x.shape)}")
    x = x.contiguous()
    n = x.shape[0]
    brk = torch.empty(n, dtype=torch.bool, device=x.device)
    outs = [brk] + ([torch.empty_like(x) for _ in range(4)]
                    if mode == "swing" else [])
    stream = torch.cuda.current_stream(x.device).cuda_stream
    fn = _build.bind("segment_scan", f"{mode}_scan_{_SUFFIX[x.dtype]}",
                     1 + len(outs), 1, 1)
    _build.check(fn(x.data_ptr(), *(o.data_ptr() for o in outs), n,
                    float(err), stream), "segment_scan")
    segment_scan_cuda.launches += 1
    return tuple(outs)


segment_scan_cuda.launches = 0
