"""Mixture-of-Experts with top-k routing and scatter dispatch (port of
``repro.models.moe``).

Dispatch is a position computation (per batch-row one-hot cumsums) and a
scatter into a capacity buffer ``[B, E, C, d]``, the expert FFN as three
batched products over the expert axis, and a gather on the way back.
Capacity overflow drops an assignment (its token keeps the residual
stream).  The aux loss is the switch load-balance term plus the router
z-loss, returned to the caller for accumulation across layers.

Types follow the reference step by step: the router, its softmax and top-k
in float32; the buffer, the expert products and the combine weights in the
activations' type.  The router's top-k is ``lax.top_k``'s order (IEEE
total order, ties to the lower expert: ``baselines.line_simpl.top_k_total``;
``torch.topk`` breaks ties otherwise).  The reference's scatter-add puts
zeros into the clamped slot for dropped assignments; the port writes only
the kept ones (their slots are unique) and sends the dropped ones to a
spare slot past the capacity that is cut off (:func:`scatter_kept`), so the
buffer is the same on every device and no host read is needed.  One device: the reference's
sharding constraints are dropped (``moe_a2a`` shards it over ranks).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.baselines.line_simpl import top_k_total
from repro_torch.models.layers import mlp, mlp_defs, silu
from repro_torch.models.params import ParamDef


def moe_defs(d: int, ff: int, n_experts: int, n_shared: int = 0):
    defs = {
        "router": ParamDef((d, n_experts), ("fsdp", None), scale=0.1),
        "wi_gate": ParamDef((n_experts, d, ff), ("experts", "fsdp", None),
                            fan_axis=1),
        "wi_up": ParamDef((n_experts, d, ff), ("experts", "fsdp", None),
                          fan_axis=1),
        "wo": ParamDef((n_experts, ff, d), ("experts", None, "fsdp"),
                       fan_axis=1),
    }
    if n_shared:
        defs["shared"] = mlp_defs(d, ff * n_shared, kind="swiglu")
    return defs


def capacity(S: int, k: int, E: int, cf: float) -> int:
    """Slots a (batch row, expert) bucket holds: ``ceil(S k / E cf / 8) 8``,
    at least 8 (``moe.py:71-72``)."""
    return max(int(math.ceil(S * k / E * cf / 8.0) * 8), 8)


def _positions_in_expert(eidx: torch.Tensor, n_experts: int) -> torch.Tensor:
    """GShard position computation, per batch-row group.

    eidx: [B, S, k] expert ids.  Returns pos [B, S, k] int32: the slot each
    assignment takes inside its (batch-row, expert) bucket, counting choice
    0 of all tokens first, then choice 1, etc.  Integer sums: exact.
    """
    B, S, k = eidx.shape
    base = torch.zeros((B, n_experts), dtype=torch.int32, device=eidx.device)
    pos = []
    for j in range(k):
        e = eidx[:, :, j].long()
        oh = F.one_hot(e, n_experts).to(torch.int32)           # [B, S, E]
        cum = torch.cumsum(oh, dim=1, dtype=torch.int32) - oh  # exclusive
        pos.append(torch.gather(cum + base[:, None, :], 2,
                                e[..., None])[..., 0])
        base = base + oh.sum(dim=1, dtype=torch.int32)
    return torch.stack(pos, dim=-1)


def scatter_kept(shape, idx, keep: torch.Tensor, cap: int,
                 values: torch.Tensor) -> torch.Tensor:
    """``zeros(shape).at[idx].add(where(keep, values, 0))`` for entries
    whose slots are unique where ``keep``: ``idx`` is a tuple of index
    tensors, the last of them the slot along a dimension of size ``cap``.
    Kept entries are written, the others go to a spare slot ``cap`` that
    is cut off (no atomics, the same buffer on every device)."""
    *lead, slot = idx
    at = len(lead)
    full = list(shape)
    full[at] = cap + 1
    buf = torch.zeros(full, dtype=values.dtype, device=values.device)
    buf[(*(i.long() for i in lead), torch.where(keep, slot, cap).long())] = \
        values
    return buf.narrow(at, 0, cap)


def route(p, x: torch.Tensor, k: int):
    """The router in float32: logits ``[..., E]``, softmax probabilities,
    the top-k weights renormalised (``max(sum, 1e-9)``) and their expert
    ids (int64)."""
    logits = x.float() @ p["router"].float()
    probs = torch.softmax(logits, dim=-1)
    w, eidx = top_k_total(probs, k)
    w = w / torch.clamp(torch.sum(w, dim=-1, keepdim=True), min=1e-9)
    return logits, probs, w, eidx


def expert_ffn(buf: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor,
               wo: torch.Tensor) -> torch.Tensor:
    """The experts' SwiGLU on a capacity buffer ``[..., E, C, d]`` (the
    reference's three einsums, in the buffer's type)."""
    g = torch.einsum("...ecd,edf->...ecf", buf, wg)
    u = torch.einsum("...ecd,edf->...ecf", buf, wu)
    return torch.einsum("...ecf,efd->...ecd", silu(g) * u, wo)


def aux_loss(logits: torch.Tensor, probs: torch.Tensor, first: torch.Tensor,
             spec) -> torch.Tensor:
    """Switch load-balance (``E sum(mean probs x share of first
    choices)``) plus the router z-loss (mean squared logsumexp), over every
    axis but the experts'."""
    E = probs.shape[-1]
    red = tuple(range(probs.dim() - 1))
    me = torch.mean(probs, dim=red)
    ce = torch.mean(F.one_hot(first, E).float(), dim=red)
    lb = E * torch.sum(me * ce)
    zl = torch.mean(torch.logsumexp(logits, dim=-1) ** 2)
    return spec.aux_loss_coef * lb + spec.router_z_coef * zl


def moe_apply(p, x: torch.Tensor, spec):
    """x: [B, S, d] -> (y [B, S, d], aux_loss scalar float32)."""
    B, S, d = x.shape
    E, k = spec.n_experts, spec.top_k
    C = capacity(S, k, E, spec.capacity_factor)
    dev = x.device

    logits, probs, w, eidx = route(p, x, k)                    # [B, S, k]
    pos = _positions_in_expert(eidx, E)
    keep = pos < C
    pos_c = torch.clamp(pos, max=C - 1).long()

    # scatter the kept assignments into the capacity buffer [B, E, C, d]
    bb = torch.arange(B, device=dev)[:, None, None].expand(B, S, k)
    buf = scatter_kept((B, E, C, d), (bb, eidx, pos), keep, C,
                       x[:, :, None, :].expand(B, S, k, d))
    out_buf = expert_ffn(buf, p["wi_gate"], p["wi_up"], p["wo"])

    # gather back + weighted combine
    y_tok = out_buf[bb, eidx, pos_c]                           # [B, S, k, d]
    wmask = (w * keep.to(w.dtype)).to(x.dtype)
    y = torch.einsum("bskd,bsk->bsd", y_tok, wmask)
    if "shared" in p:
        y = y + mlp(p["shared"], x, kind="swiglu")
    return y, aux_loss(logits, probs, eidx[..., 0], spec)

