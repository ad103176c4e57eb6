"""Trial-and-error ACF-constraint adapter for parameterized lossy baselines
(port of ``repro/baselines/constrain.py``).

The paper (§5.1): "Since enforcing the ACF constraint while compressing is
not straightforward [for PMC/SWING/SP/FFT], we perform a trial-and-error
exploration of the parameters of these methods while recording the ACF
deviation."  This module automates that exploration with a bracketing +
bisection search over the method's error parameter, maximizing compression
subject to the exact ACF deviation bound.  The search itself is the
reference's Python-float bisection, so the port makes the same trials; each
trial's deviation is measured on ``device`` (on the card: the ``lag_dot``
and ``prefix_sum`` kernels).
"""
from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch

from repro_torch.core import measures
from repro_torch.core.acf import acf, aggregate_series, pacf_from_acf
from repro_torch.core.cameo import CameoConfig, _device


def acf_deviation(x, recon, cfg: CameoConfig, *, device="cuda") -> float:
    """D(S(recon), S(x)) from scratch, float64, on ``device``."""
    dev = _device(device)
    y0 = aggregate_series(torch.as_tensor(x, dtype=torch.float64).to(dev),
                          cfg.kappa)
    y1 = aggregate_series(torch.as_tensor(recon, dtype=torch.float64).to(dev),
                          cfg.kappa)
    mfn = measures.get_measure(cfg.measure)
    s0 = acf(y0, cfg.lags)
    s1 = acf(y1, cfg.lags)
    if cfg.stat == "pacf":
        s0, s1 = pacf_from_acf(s0), pacf_from_acf(s1)
    return float(mfn(s1, s0))


def acf_constrained_search(
    x,
    cfg: CameoConfig,
    compress_fn: Callable,
    *,
    param_is_int: bool = False,
    lo: float = None,
    hi: float = None,
    iters: int = 12,
    device="cuda",
) -> Tuple[torch.Tensor, int, float, float]:
    """Find the most aggressive parameter for ``compress_fn(x, p, device=)``
    whose reconstruction keeps the ACF deviation <= cfg.eps.

    For error-bound methods (PMC/SWING/SP) larger p => more compression;
    for FFT the parameter is the kept-coefficient count m where *smaller*
    m => more compression (pass ``param_is_int=True``).

    Returns (recon, stored_values, achieved_dev, param); ``recon`` lies on
    ``device``.
    """
    dev = _device(device)
    x = (x.detach().cpu().numpy() if isinstance(x, torch.Tensor)
         else np.asarray(x)).astype(np.float64)
    if cfg.kappa > 1:
        n = (x.shape[0] // cfg.kappa) * cfg.kappa
        x = x[:n]
    rng = float(np.max(x) - np.min(x))
    xd = torch.from_numpy(x).to(dev)

    def trial(p):
        recon, stored = compress_fn(xd, p, device=dev)
        return recon, stored, acf_deviation(xd, recon, cfg, device=dev)

    if param_is_int:
        # FFT-style: bisect kept-coefficient count in [1, n//2]
        lo_m, hi_m = 1, x.shape[0] // 2 + 1
        best = None
        while lo_m < hi_m:
            mid = (lo_m + hi_m) // 2
            recon, stored, d = trial(mid)
            if d <= cfg.eps:
                best = (recon, stored, d, float(mid))
                hi_m = mid
            else:
                lo_m = mid + 1
        if best is None:
            m = x.shape[0] // 2 + 1
            best = (*trial(m), float(m))
        return best

    lo = 1e-8 * rng if lo is None else lo
    hi = 2.0 * rng if hi is None else hi
    # larger err is always more compression: bisect the largest feasible err
    best = None
    for _ in range(iters):
        mid = float(np.sqrt(lo * hi))  # log-space bisection
        recon, stored, d = trial(mid)
        if d <= cfg.eps:
            best = (recon, stored, d, mid)
            lo = mid
        else:
            hi = mid
    if best is None:
        best = (*trial(lo), lo)
    return best
