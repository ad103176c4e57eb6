"""Domain-transform baseline: FFT top-m coefficient truncation (paper §5.1;
port of ``repro/baselines/transform.py``).

``fft_compress(x, m)`` keeps the ``m`` largest-magnitude rFFT coefficients
(DC always kept), zeroes the rest, and reconstructs by inverse transform.
Storage: 2 values per kept complex coefficient + 1 for its index.

The reference takes numpy's FFT; the port takes ``torch.fft`` (cuFFT on the
card, PocketFFT on the CPU), whose coefficients may differ from numpy's in
the last bits, so the reconstruction agrees to a tolerance, not bit for
bit, and where two magnitudes tie at the cut the kept set may differ.
"""
from __future__ import annotations

import torch

from repro_torch.core.cameo import _device


def fft_compress(x, m: int, *, device="cuda"):
    """``(recon [n], stored)`` on ``device`` (the card unless the caller
    asks for the CPU)."""
    x = torch.as_tensor(x, dtype=torch.float64).to(_device(device))
    n = x.shape[0]
    spec = torch.fft.rfft(x)
    m = int(max(1, min(m, spec.shape[0])))
    mag = torch.abs(spec)
    mag[0] = float("inf")  # always keep DC
    # numpy's argsort(mag)[::-1]: largest first, later index first on ties
    keep = torch.flip(torch.sort(mag, stable=True).indices, (0,))[:m]
    trunc = torch.zeros_like(spec)
    trunc[keep] = spec[keep]
    return torch.fft.irfft(trunc, n=n), 3 * m
