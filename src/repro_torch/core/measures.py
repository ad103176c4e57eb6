"""Quality measures ``D(a, b)`` (paper §2.3; port of
``repro/core/measures.py``).

Each reduces over the last axis, so a measure of two ``[L]`` vectors is a
scalar and a measure of ``[K, L]`` rows against an ``[L]`` target is
``[K]`` (the JAX package gets the batched form through ``vmap``).
"""
from __future__ import annotations

import torch


def mae(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(a - b), dim=-1)


def rmse(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.mean((a - b) ** 2, dim=-1))


def nrmse(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    rng = torch.amax(a, dim=-1) - torch.amin(a, dim=-1)
    rng = torch.where(rng <= 0, torch.ones_like(rng), rng)
    return rmse(a, b) / rng


def mape(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    denom = torch.clamp_min(torch.abs(a), 1e-12)
    return torch.mean(torch.abs(a - b) / denom, dim=-1)


def cheb(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Chebyshev distance: max absolute deviation across lags."""
    return torch.amax(torch.abs(a - b), dim=-1)


def msmape(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Modified symmetric MAPE (paper §2.3), with the expanding-window
    mean-absolute-deviation stabilizer ``S_i``."""
    n = a.shape[-1]
    idx = torch.arange(1, n + 1, dtype=a.dtype, device=a.device)
    csum = torch.cumsum(a, dim=-1)
    # expanding mean of a_1..a_{i-1}; define S_1 = 0.
    prev_mean = torch.where(idx > 1, (csum - a) / torch.clamp_min(idx - 1, 1),
                            0.0)
    # expanding mean absolute deviation around the running mean (the causal
    # cumulative form of the paper's S_i).
    dev = torch.abs(a - prev_mean)
    cdev = torch.cumsum(dev, dim=-1)
    s = torch.where(idx > 1, (cdev - dev) / torch.clamp_min(idx - 1, 1), 0.0)
    denom = torch.abs(a + b) / 2.0 + s
    denom = torch.clamp_min(denom, 1e-12)
    return torch.mean(torch.abs(a - b) / denom, dim=-1)


def psnr(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    rng = torch.amax(a, dim=-1) - torch.amin(a, dim=-1)
    m = torch.mean((a - b) ** 2, dim=-1)
    return 10.0 * torch.log10(torch.clamp_min(rng * rng, 1e-30)
                              / torch.clamp_min(m, 1e-30))


_MEASURES = {
    "mae": mae,
    "rmse": rmse,
    "nrmse": nrmse,
    "mape": mape,
    "cheb": cheb,
    "msmape": msmape,
}


def get_measure(name: str):
    try:
        return _MEASURES[name]
    except KeyError:
        raise ValueError(f"unknown measure {name!r}; have {sorted(_MEASURES)}")
