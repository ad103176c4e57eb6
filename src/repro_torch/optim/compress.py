"""Gradient compression with error feedback (port of
``repro.optim.compress``): keep only the important points of each
gradient tensor and let an error-feedback residual carry the rest, as
CAMEO keeps the statistically important samples and lets linear
interpolation carry the rest.

Two codecs:

* ``topk``  — keep the top ``ratio`` fraction by magnitude: every entry
  whose magnitude reaches the k-th largest (ties at the threshold are all
  kept, as the reference keeps them);
* ``int8``  — per-tensor scale quantization, round half to even.

Used by the explicit data-parallel step (``train/dp_shardmap.py`` in the
reference).  Error feedback makes both codecs convergent.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from repro_torch.tree import tree_map, tree_map_n


@dataclasses.dataclass(frozen=True)
class CompressConfig:
    codec: str = "topk"    # "topk" | "int8" | "none"
    ratio: float = 0.05    # topk keep fraction


def topk_mask(g: torch.Tensor, ratio: float) -> torch.Tensor:
    """1 where ``|g|`` is at least the k-th largest magnitude (k =
    ``max(1, int(ratio * numel))``), else 0, in ``g``'s dtype."""
    flat = torch.abs(g.reshape(-1))
    k = max(1, int(ratio * flat.shape[0]))
    thresh = torch.topk(flat, k).values[-1]
    return (torch.abs(g) >= thresh).to(g.dtype)


def compress(g: torch.Tensor,
             cfg: CompressConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (compressed-then-decompressed gradient, residual)."""
    if cfg.codec == "none":
        return g, torch.zeros_like(g)
    if cfg.codec == "topk":
        kept = g * topk_mask(g, cfg.ratio)
        return kept, g - kept
    if cfg.codec == "int8":
        scale = torch.clamp(torch.max(torch.abs(g)), min=1e-12) / 127.0
        q = torch.clamp(torch.round(g / scale), -127, 127)
        deq = q * scale
        return deq, g - deq
    raise ValueError(cfg.codec)


def compress_with_feedback(grads, residuals, cfg: CompressConfig):
    """Error feedback: compress (g + residual) leaf by leaf; the unsent
    mass becomes the next residual.  Returns (sent, residuals)."""
    return tree_map_n(lambda g, r: compress(g.float() + r, cfg), 2, grads,
                      residuals)


def init_residuals(params):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)
