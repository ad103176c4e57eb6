"""Adafactor (Shazeer & Stern 2018; port of ``repro.optim.adafactor``):
factored second moments.

For the largest MoE configs the optimizer state shrinks from two copies
of the parameters (AdamW) to rank-1 factors.  A leaf whose last two axes
are both at least ``min_dim_factored`` keeps a row factor (the mean of
g^2 over the last axis) and a column factor (over the second last);
smaller and 1-D leaves keep the full second moment.  Each update is
clipped to an RMS of ``clip_threshold``.  The arithmetic is the
reference's, in float32; parameters are updated in place under
``torch.no_grad()``.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from repro_torch.tree import leaves, tree_map


@dataclasses.dataclass(frozen=True)
class AdafactorConfig:
    decay: float = 0.99
    eps: float = 1e-30
    clip_threshold: float = 1.0
    min_dim_factored: int = 128


class AdafactorState(NamedTuple):
    vr: dict     # row factors (or full v for small/1D params)
    vc: dict     # col factors ([1] zeros for unfactored)
    step: torch.Tensor


def _factored(shape, cfg) -> bool:
    return len(shape) >= 2 and shape[-1] >= cfg.min_dim_factored \
        and shape[-2] >= cfg.min_dim_factored


def adafactor_init(params, cfg: AdafactorConfig) -> AdafactorState:
    def vr_init(p):
        shape = p.shape[:-1] if _factored(p.shape, cfg) else p.shape
        return torch.zeros(shape, dtype=torch.float32, device=p.device)

    def vc_init(p):
        shape = p.shape[:-2] + p.shape[-1:] if _factored(p.shape, cfg) \
            else (1,)
        return torch.zeros(shape, dtype=torch.float32, device=p.device)

    first = leaves(params)[0]
    return AdafactorState(vr=tree_map(vr_init, params),
                          vc=tree_map(vc_init, params),
                          step=torch.zeros((), dtype=torch.int32,
                                           device=first.device))


@torch.no_grad()
def adafactor_update(grads, state: AdafactorState, params, lr,
                     cfg: AdafactorConfig):
    """One Adafactor step, in place: returns (params, new state)."""
    step = state.step + 1
    beta = 1.0 - (step.to(torch.float32) + 1.0) ** -0.8   # decay schedule
    beta = torch.clamp(beta, max=cfg.decay)
    lr = torch.as_tensor(lr, dtype=torch.float32)

    def upd(g, vr, vc, p):
        g = g.float()
        g2 = g * g + cfg.eps
        if _factored(p.shape, cfg):
            vr_new = beta * vr + (1 - beta) * torch.mean(g2, dim=-1)
            vc_new = beta * vc + (1 - beta) * torch.mean(g2, dim=-2)
            rfac = vr_new / torch.clamp(
                torch.mean(vr_new, dim=-1, keepdim=True), min=cfg.eps)
            u = g / (torch.sqrt(rfac)[..., None]
                     * torch.sqrt(vc_new)[..., None, :] + cfg.eps)
            vc.copy_(vc_new)
        else:
            vr_new = beta * vr + (1 - beta) * g2
            u = g / (torch.sqrt(vr_new) + cfg.eps)
        vr.copy_(vr_new)
        # update clipping (RMS threshold)
        rms = torch.sqrt(torch.mean(u * u) + 1e-30)
        u = u / torch.clamp(rms / cfg.clip_threshold, min=1.0)
        p.copy_((p.float() - lr * u).to(p.dtype))

    for g, vr, vc, p in zip(leaves(grads), leaves(state.vr),
                            leaves(state.vc), leaves(params)):
        upd(g, vr, vc, p)
    return params, AdafactorState(vr=state.vr, vc=state.vc, step=step)
