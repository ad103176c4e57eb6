"""AdamW (port of ``repro.optim.adamw``), in the reference's arithmetic.

The state mirrors the parameter tree (nested dicts of tensors); the
update is the reference's, computed in float32 and cast back to each
leaf's dtype: ``mhat / (sqrt(vhat) + eps) + wd * p``.  ``torch.optim.AdamW``
is not used: it rounds otherwise (its own order, the state in the
parameter's type throughout).  ``state_dtype`` keeps m and v in another
type (bfloat16 for the largest configs); ``None`` keeps the parameter's.

``adamw_update`` writes the new parameters, m and v into their tensors
in place under ``torch.no_grad()`` and returns them with the new step and
the gradients' global norm.  A large leaf is updated in slices along its
first axis: the update is elementwise, so the slices give the same bits
as the whole, with a fraction of the float32 temporaries.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from repro_torch.tree import leaves, tree_map

# elements a slice of a leaf's update (float32 temporaries of 256 MiB each)
_SLICE = 1 << 26


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: Optional[float] = 1.0
    state_dtype: Optional[str] = None   # None: same as param dtype


class AdamWState(NamedTuple):
    m: dict
    v: dict
    step: torch.Tensor


def global_norm(tree) -> torch.Tensor:
    """sqrt of the float32 sum of squares, the leaves added in
    ``jax.tree.leaves`` order from 0 (as the reference's Python ``sum``)."""
    sq = 0
    for g in leaves(tree):
        gf = g.float()
        sq = sq + torch.sum(gf * gf)
    return torch.sqrt(torch.as_tensor(sq, dtype=torch.float32))


def _clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)


def clip_by_global_norm(grads, max_norm):
    """(the gradients in float32 scaled to a global norm of at most
    ``max_norm``, their global norm before)."""
    norm = global_norm(grads)
    scale = _clip_scale(norm, max_norm)
    return tree_map(lambda g: g.float() * scale, grads), norm


def _dtype(name):
    return getattr(torch, name) if isinstance(name, str) else name


def adamw_init(params, cfg: AdamWConfig) -> AdamWState:
    dt = _dtype(cfg.state_dtype) if cfg.state_dtype else None

    def z(p):
        return torch.zeros(p.shape, dtype=dt or p.dtype, device=p.device)

    first = leaves(params)[0]
    return AdamWState(m=tree_map(z, params), v=tree_map(z, params),
                      step=torch.zeros((), dtype=torch.int32,
                                       device=first.device))


def _slices(*ts):
    """Matching slices of ``ts`` along their first axis (the whole tensors
    when small or 0-d)."""
    t0 = ts[0]
    if t0.dim() == 0 or t0.numel() <= _SLICE:
        return [ts]
    rows = max(1, _SLICE // max(t0[0].numel(), 1))
    return list(zip(*(t.split(rows) for t in ts)))


@torch.no_grad()
def adamw_update(grads, state: AdamWState, params, lr, cfg: AdamWConfig):
    """One AdamW step, in place: returns (params, new state, global norm
    of the gradients before clipping)."""
    step = state.step + 1
    gnorm = global_norm(grads)
    scale = _clip_scale(gnorm, cfg.clip_norm) \
        if cfg.clip_norm is not None else None
    b1, b2 = cfg.b1, cfg.b2
    stepf = step.to(torch.float32)
    c1 = 1.0 - torch.pow(b1, stepf)
    c2 = 1.0 - torch.pow(b2, stepf)
    lr = torch.as_tensor(lr, dtype=torch.float32)

    def upd(g, m, v, p):
        gf = g.float()
        if scale is not None:
            gf = gf * scale
        mf = b1 * m.float() + (1 - b1) * gf
        vf = b2 * v.float() + (1 - b2) * gf * gf
        mhat = mf / c1
        vhat = vf / c2
        delta = mhat / (torch.sqrt(vhat) + cfg.eps) + \
            cfg.weight_decay * p.float()
        p.copy_((p.float() - lr * delta).to(p.dtype))
        m.copy_(mf.to(m.dtype))
        v.copy_(vf.to(v.dtype))

    for g, m, v, p in zip(leaves(grads), leaves(state.m), leaves(state.v),
                          leaves(params)):
        for part in _slices(g, m, v, p):
            upd(*part)
    return params, AdamWState(m=state.m, v=state.v, step=step), gnorm
