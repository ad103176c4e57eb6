"""Deterministic, restart-consistent data pipeline (port of
``repro.data.pipeline``).

Batches are pure functions of (seed, step): after a preemption the loop
resumes at the checkpointed step and sees exactly the data it would have
seen (no loader state to checkpoint).

Two front doors:

* ``token_batch``      — synthetic LM token batches for the model zoo,
  drawn from a ``torch.Generator`` seeded by ``zlib.crc32`` of (seed,
  step) as ``models.params.path_seed`` seeds a leaf: deterministic in
  every process and on every device, but not ``jax.random``'s numbers;
* ``SeriesTokenizer``  — the CAMEO data plane: a sensor series (raw or
  CAMEO-compressed) binned into vocab tokens, cut into windows and
  batched (``series_windows``, ``forecast_batches``; numpy, as the
  reference's, so their tokens, windows and batch indices are the
  reference's bit for bit).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.cameo import _device
from repro_torch.models.params import path_seed


def token_batch(cfg, batch: int, seq: int, step: int, seed: int = 0,
                device="cuda") -> dict:
    """Synthetic LM batch on ``device`` (the card unless the caller passes
    ``"cpu"``): ``tokens [batch, seq]`` int64 in ``[0, cfg.vocab)`` and,
    for the ``vision_stub`` frontend, ``patch_embeds [batch, n_patches,
    d_model]`` float32 (0.02 x a normal draw).  Drawn on the CPU, so every
    device gets the same batch."""
    device = _device(device)
    gen = torch.Generator().manual_seed(path_seed(seed, ("step", str(step))))
    out = {"tokens": torch.randint(0, cfg.vocab, (batch, seq),
                                   generator=gen).to(device)}
    if cfg.frontend == "vision_stub" and cfg.n_patches:
        out["patch_embeds"] = (0.02 * torch.randn(
            (batch, cfg.n_patches, cfg.d_model), generator=gen)).to(device)
    return out


@dataclasses.dataclass
class SeriesTokenizer:
    """Uniform-bin quantizer mapping a scalar series into LM tokens.

    Fit on the raw series (min/max), so compressed and raw variants of the
    same series share a codebook (paper §5.8 trains on compressed data and
    evaluates on raw).
    """
    vocab: int
    lo: float = 0.0
    hi: float = 1.0

    @classmethod
    def fit(cls, x, vocab: int) -> "SeriesTokenizer":
        x = np.asarray(x)
        lo, hi = float(np.min(x)), float(np.max(x))
        if hi <= lo:
            hi = lo + 1.0
        return cls(vocab=vocab, lo=lo, hi=hi)

    def encode(self, x) -> np.ndarray:
        x = np.asarray(x)
        t = (x - self.lo) / (self.hi - self.lo)
        return np.clip((t * (self.vocab - 1)).round(), 0,
                       self.vocab - 1).astype(np.int32)

    def decode(self, tokens) -> np.ndarray:
        t = np.asarray(tokens, np.float64) / (self.vocab - 1)
        return t * (self.hi - self.lo) + self.lo


def series_windows(tokens: np.ndarray, window: int, stride: int) -> np.ndarray:
    """[n] token stream -> [num_windows, window] training rows."""
    n = tokens.shape[0]
    starts = np.arange(0, n - window + 1, stride)
    return np.stack([tokens[s:s + window] for s in starts])


def forecast_batches(windows: np.ndarray, batch: int, step: int,
                     seed: int = 0, device="cuda") -> dict:
    """Deterministic batch of windows for a given step (the reference's
    numpy draw), ``{"tokens": [batch, window]}`` on ``device`` (the card
    unless the caller passes ``"cpu"``)."""
    rng = np.random.default_rng(seed + step)
    idx = rng.integers(0, windows.shape[0], size=batch)
    return {"tokens": torch.from_numpy(np.ascontiguousarray(
        windows[idx])).to(_device(device))}
