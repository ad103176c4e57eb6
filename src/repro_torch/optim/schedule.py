"""Learning-rate schedules (port of ``repro.optim.schedule``): pure
functions of the step, computed in float32 tensors as the reference's
``jnp`` forms are.  The result is a 0-d float32 tensor on ``step``'s
device (the CPU for a Python int): a 0-d CPU tensor multiplies a card
tensor as a scalar, with no copy and no wait."""
from __future__ import annotations

import math

import torch


def _step(step) -> torch.Tensor:
    if isinstance(step, torch.Tensor):
        return step.to(torch.float32)
    return torch.tensor(step, dtype=torch.float32)


def warmup_cosine(step, *, peak_lr: float, warmup: int, total: int,
                  final_frac: float = 0.1) -> torch.Tensor:
    step = _step(step)
    warm = peak_lr * (step + 1.0) / max(warmup, 1)   # lr > 0 from step 0
    prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = final_frac + (1 - final_frac) * 0.5 * (1 + torch.cos(math.pi * prog))
    return torch.where(step < warmup, warm, peak_lr * cos)


def constant(step, *, peak_lr: float, **_) -> torch.Tensor:
    dev = step.device if isinstance(step, torch.Tensor) else None
    return torch.full((), peak_lr, dtype=torch.float32, device=dev)


def warmup_linear(step, *, peak_lr: float, warmup: int, total: int,
                  **_) -> torch.Tensor:
    step = _step(step)
    warm = peak_lr * (step + 1.0) / max(warmup, 1)
    prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
    return torch.where(step < warmup, warm, peak_lr * (1.0 - prog))


SCHEDULES = {"warmup_cosine": warmup_cosine, "constant": constant,
             "warmup_linear": warmup_linear}
