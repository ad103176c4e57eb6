"""Mamba2 (state-space duality) block (port of ``repro.models.mamba``):
the chunked SSD scan for prefill, the O(1)-state recurrent step for decode
(arXiv:2405.21060).

The within-chunk quadratic term and the chunk-state contraction are
products over the chunk; the inter-chunk recurrence is a Python loop over
chunks carrying the ``[B, G, rep, P, N]`` state (the reference's
``lax.scan``), so the ``[B, Q, Q, G, rep]`` decay matrix exists for one
chunk at a time.  All SSD math is float32, as the reference's.

Two departures, each giving the reference's values where the reference's
are finite:

* the reference's three-operand einsum ``"bijg,bijgr,bjgrp->bigrp"`` is
  written in two steps (scores times the decay matrix, then the
  contraction over ``j``), so no ``[b, i, j, g, r, p]`` product is formed;
* the decay matrix is ``exp`` of the pairwise log-decays with the upper
  triangle set to -inf first.  The reference takes ``exp(diff) * causal``:
  above the diagonal ``diff`` is the decay between j > i, positive, and at
  a chunk of 256 with ``dt`` near 1 it passes float32's range, where
  ``inf * 0`` makes the output NaN (ROADMAP C21).

One device: the reference's sharding constraints are dropped.  The decode
step writes the new conv window and SSM state into the cache's tensors in
place (the reference returns new arrays) and returns the cache.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch import sharding as shd
from repro_torch.models.layers import rmsnorm_defs, silu
from repro_torch.models.params import ParamDef, TensorSpec


def mamba_defs(spec):
    d, di, gn, hm, wc = (spec.d_model, spec.d_inner,
                         spec.n_groups * spec.d_state, spec.m_heads,
                         spec.conv_width)
    return {
        "in_z": ParamDef((d, di), ("fsdp", "tp")),
        "in_x": ParamDef((d, di), ("fsdp", "tp")),
        "in_B": ParamDef((d, gn), ("fsdp", None)),
        "in_C": ParamDef((d, gn), ("fsdp", None)),
        "in_dt": ParamDef((d, hm), ("fsdp", "tp")),
        "conv_x": ParamDef((wc, di), (None, "tp"), scale=0.5),
        "conv_B": ParamDef((wc, gn), (None, None), scale=0.5),
        "conv_C": ParamDef((wc, gn), (None, None), scale=0.5),
        "A_log": ParamDef((hm,), ("tp",), init="ones"),
        "dt_bias": ParamDef((hm,), ("tp",), init="zeros"),
        "D": ParamDef((hm,), ("tp",), init="ones"),
        "norm": rmsnorm_defs(di, axes=("tp",)),
        "out": ParamDef((di, d), ("tp", "fsdp")),
    }


def _causal_conv(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv: x [B, T, C], kernel [w, C] -> [B, T, C] in
    x's type.  The window's products summed in float32 and rounded once
    (XLA widens a bfloat16 convolution to float32 on the CPU)."""
    w = kernel.shape[0]
    xf = F.pad(x.float(), (0, 0, w - 1, 0))
    kf = kernel.float()
    T = x.shape[1]
    acc = xf[:, 0:T] * kf[0]
    for i in range(1, w):
        acc = acc + xf[:, i:i + T] * kf[i]
    return acc.to(x.dtype)


def _gated_norm(p, y: torch.Tensor, z: torch.Tensor, eps: float = 1e-6):
    """``y * silu(z)`` in y's type, then an RMS norm with float32
    statistics, cast back to y's type."""
    g = y * silu(z)
    gf = g.float()
    var = torch.mean(gf * gf, dim=-1, keepdim=True)
    return (gf * torch.rsqrt(var + eps) * p["scale"].float()).to(y.dtype)


def ssd_chunked(x, dt, A, Bm, Cm, D, Q: int, s0=None):
    """Chunked SSD.  x [B,T,H,P] f32, dt [B,T,H] (post-softplus), A [H]
    (< 0), Bm/Cm [B,T,G,N].  Returns (y [B,T,H,P], final_state
    [B,H,P,N])."""
    B_, T, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    rep = H // G
    nc = T // Q
    if nc * Q != T:
        raise ValueError(f"T = {T} is not a multiple of the chunk {Q}")
    Ah = A.reshape(G, rep)
    Dh = D.reshape(G, rep)
    causal = torch.tril(torch.ones((Q, Q), dtype=torch.bool,
                                   device=x.device))[None, :, :, None, None]
    s = torch.zeros((B_, G, rep, P, N), dtype=x.dtype, device=x.device) \
        if s0 is None else s0.reshape(B_, G, rep, P, N)
    xq = x.reshape(B_, nc, Q, G, rep, P)
    dtq = dt.reshape(B_, nc, Q, G, rep)
    Bq = Bm.reshape(B_, nc, Q, G, N)
    Cq = Cm.reshape(B_, nc, Q, G, N)
    ys = []
    for c in range(nc):
        xc, dtc, Bc, Cc = xq[:, c], dtq[:, c], Bq[:, c], Cq[:, c]
        dA = dtc * Ah                                  # [B,Q,G,rep] (<= 0)
        cum = torch.cumsum(dA, dim=1)
        # within-chunk quadratic term
        diff = cum[:, :, None] - cum[:, None, :]       # [B,Qi,Qj,G,rep]
        Lmat = torch.exp(torch.where(causal, diff, float("-inf")))
        scores = torch.einsum("bign,bjgn->bijg", Cc, Bc)
        xt = xc * dtc[..., None]                       # x_j * dt_j
        y_diag = torch.einsum("bijgr,bjgrp->bigrp", scores[..., None] * Lmat,
                              xt)
        # contribution of the carried state
        decay_in = torch.exp(cum)                      # [B,Q,G,rep]
        y_off = torch.einsum("bign,bgrpn->bigrp", Cc, s) * decay_in[..., None]
        # new chunk state
        decay_end = torch.exp(cum[:, -1:] - cum)       # [B,Q,G,rep]
        st = torch.einsum("bjgn,bjgrp->bgrpn", Bc, xt * decay_end[..., None])
        chunk_decay = torch.exp(cum[:, -1])            # [B,G,rep]
        s = s * chunk_decay[..., None, None] + st
        ys.append(y_diag + y_off + Dh[..., None] * xc)
    y = torch.stack(ys, dim=1).reshape(B_, T, H, P)
    return y, s.reshape(B_, H, P, N)


class MambaCache(NamedTuple):
    ssm: torch.Tensor      # [B, H, P, N] f32
    conv_x: torch.Tensor   # [B, w-1, d_inner]
    conv_B: torch.Tensor   # [B, w-1, G*N]
    conv_C: torch.Tensor   # [B, w-1, G*N]


def init_mamba_cache(spec, B: int, dtype, device) -> MambaCache:
    w = spec.conv_width
    gn = spec.n_groups * spec.d_state
    return MambaCache(
        ssm=torch.zeros((B, spec.m_heads, spec.headdim, spec.d_state),
                        dtype=torch.float32, device=device),
        conv_x=torch.zeros((B, w - 1, spec.d_inner), dtype=dtype,
                           device=device),
        conv_B=torch.zeros((B, w - 1, gn), dtype=dtype, device=device),
        conv_C=torch.zeros((B, w - 1, gn), dtype=dtype, device=device))


def mamba_cache_specs(spec, B: int, dtype, mesh, rules) -> MambaCache:
    """The cache's :class:`~repro_torch.models.params.TensorSpec`s with
    their shardings."""
    w = spec.conv_width

    def sds(shape, axes, dt):
        return TensorSpec(shape, dt,
                          shd.named_sharding(shape, axes, mesh, rules))

    gn = spec.n_groups * spec.d_state
    return MambaCache(
        ssm=sds((B, spec.m_heads, spec.headdim, spec.d_state),
                ("act_cache_batch", "act_heads", None, None), torch.float32),
        conv_x=sds((B, w - 1, spec.d_inner),
                   ("act_cache_batch", None, "act_inner"), dtype),
        conv_B=sds((B, w - 1, gn), ("act_cache_batch", None, None), dtype),
        conv_C=sds((B, w - 1, gn), ("act_cache_batch", None, None), dtype),
    )


def _projections(p, x: torch.Tensor):
    return (x @ p["in_z"], x @ p["in_x"], x @ p["in_B"], x @ p["in_C"],
            x @ p["in_dt"])


def _dt_softplus(dt: torch.Tensor, p) -> torch.Tensor:
    return F.softplus(dt.float() + p["dt_bias"].float())


def mamba_train(p, x: torch.Tensor, spec, s0=None):
    """Full-sequence Mamba2 block.  x [B, T, d] -> (y, final MambaCache)."""
    B_, T, d = x.shape
    H, P, G, N = spec.m_heads, spec.headdim, spec.n_groups, spec.d_state

    z, xx, Bp, Cp, dt = _projections(p, x)
    xx_conv_in, Bp_in, Cp_in = xx, Bp, Cp
    xx = silu(_causal_conv(xx, p["conv_x"]))
    Bp = silu(_causal_conv(Bp, p["conv_B"]))
    Cp = silu(_causal_conv(Cp, p["conv_C"]))

    A = -torch.exp(p["A_log"].float())
    dt_f = _dt_softplus(dt, p)
    # pad T to a chunk multiple; padded steps have dt = 0: identity updates
    Q = spec.mamba_chunk
    pad = (-T) % Q
    Tp = T + pad

    def padt(a):
        return F.pad(a, (0,) * (2 * (a.dim() - 2)) + (0, pad))

    live = (torch.arange(Tp, device=x.device) < T)[None, :, None]
    y, s_fin = ssd_chunked(
        padt(xx.float()).reshape(B_, Tp, H, P), padt(dt_f) * live, A,
        padt(Bp.float()).reshape(B_, Tp, G, N),
        padt(Cp.float()).reshape(B_, Tp, G, N),
        p["D"].float(), Q=Q, s0=None if s0 is None else s0.float())
    y = y[:, :T].reshape(B_, T, H * P).to(x.dtype)
    y = _gated_norm(p["norm"], y, z)
    out = y @ p["out"]
    w = spec.conv_width
    cache = MambaCache(ssm=s_fin,
                       conv_x=xx_conv_in[:, T - (w - 1):].contiguous(),
                       conv_B=Bp_in[:, T - (w - 1):].contiguous(),
                       conv_C=Cp_in[:, T - (w - 1):].contiguous())
    return out, cache


def _conv_step(cache_c: torch.Tensor, new: torch.Tensor,
               kernel: torch.Tensor) -> torch.Tensor:
    """One causal-conv output from the cached window and the new input, in
    float32, SiLU'd and cast to the input's type; the cache's window moves
    on by one in place."""
    window = torch.cat([cache_c, new], dim=1)                 # [B, w, C]
    out = torch.einsum("bwc,wc->bc", window.float(), kernel.float())
    cache_c.copy_(window[:, 1:])
    return silu(out).to(new.dtype)


def mamba_decode(p, x: torch.Tensor, cache: MambaCache, spec):
    """Single-token recurrent step.  x [B, 1, d] -> (y [B, 1, d], cache),
    the cache updated in place."""
    B_ = x.shape[0]
    H, P, G, N = spec.m_heads, spec.headdim, spec.n_groups, spec.d_state

    z, xx, Bp, Cp, dt = _projections(p, x)
    xx1 = _conv_step(cache.conv_x, xx, p["conv_x"])
    Bp1 = _conv_step(cache.conv_B, Bp, p["conv_B"])
    Cp1 = _conv_step(cache.conv_C, Cp, p["conv_C"])

    A = -torch.exp(p["A_log"].float())                         # [H]
    dt_f = _dt_softplus(dt[:, 0], p)                           # [B, H]
    xh = xx1.float().reshape(B_, H, P)
    Bh = Bp1.float().reshape(B_, G, N)
    Ch = Cp1.float().reshape(B_, G, N)
    rep = H // G

    decay = torch.exp(dt_f * A)                                # [B, H]
    # state' = state * decay + (dt x) outer B
    xdt = (xh * dt_f[..., None]).reshape(B_, G, rep, P)
    upd = torch.einsum("bgn,bgrp->bgrpn", Bh, xdt).reshape(B_, H, P, N)
    s = cache.ssm * decay[..., None, None] + upd
    cache.ssm.copy_(s)
    y = torch.einsum("bgn,bgrpn->bgrp", Ch,
                     s.reshape(B_, G, rep, P, N)).reshape(B_, H, P)
    y = y + p["D"].float()[None, :, None] * xh
    y = y.reshape(B_, 1, H * P).to(x.dtype)
    y = _gated_norm(p["norm"], y, z)
    return y @ p["out"], cache
