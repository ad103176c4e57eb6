"""Line-simplification baselines adapted to the ACF constraint (paper §5.1;
port of ``repro/baselines/line_simpl.py``).

The engine mirrors CAMEO's rounds mode, but candidates are ranked by
*geometric* criteria instead of ACF impact.  Every accepted round is still
validated with CAMEO's exact incremental aggregate update, so each baseline
gives the same hard guarantee ``D(ACF(X'), ACF(X)) <= eps``.

Ranks (lower = removed first):

* ``vw_rank``     — Visvalingam–Whyatt triangle area.
* ``tp_rank_s``   — Turning Points, sum-of-absolute-values importance;
                    non-turning points score -1 (removed first).
* ``tp_rank_m``   — Turning Points, mean-absolute-error importance.
* ``pip_rank_v``  — Perceptual Important Points, vertical distance.
* ``pip_rank_e``  — PIP, euclidean (perpendicular) distance.

On the card a round runs the port's kernels: the dense Eq. 10/11 update's
prefix sums (``prefix_sum``) and its bilinear term (``dense_sxx``), after
the Eq. 7 aggregates at init (``lag_dot`` and ``prefix_sum``).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.acf import (acf_from_aggregates, aggregate_series,
                                  extract_aggregates)
from repro_torch.core.aggregates import (alive_neighbors, apply_delta_dense,
                                         interpolate_at)
from repro_torch.core.cameo import (CameoConfig, CompressResult, _device,
                                    _independent_set, _measure_fn,
                                    _reconstruct, _stat_transform,
                                    _x_to_y_delta)
from repro_torch.kernels.ref import sqrt_rn

# ---------------------------------------------------------------------------
# geometric ranking functions: (xr, alive) -> [n] scores
# ---------------------------------------------------------------------------


def _neighbor_vals(xr, alive):
    n = xr.shape[0]
    idx = torch.arange(n, dtype=torch.int32, device=xr.device)
    prev, nxt = alive_neighbors(alive)
    p = torch.clamp(prev, 0, n - 1)
    q = torch.clamp(nxt, 0, n - 1)
    return idx, prev, nxt, xr[p], xr[q]


def vw_rank(xr, alive):
    """Triangle area over (prev, i, next) — the VW criterion."""
    idx, prev, nxt, xp, xq = _neighbor_vals(xr, alive)
    dt = xr.dtype
    base = (nxt - prev).to(dt)
    # 2*area of triangle (prev, xp) (i, x_i) (next, xq)
    area2 = torch.abs(base * (xr - xp) - (idx - prev).to(dt) * (xq - xp))
    return 0.5 * area2


def _is_turning_point(xr, alive):
    """Direction change w.r.t. alive neighbors."""
    _, _, _, xp, xq = _neighbor_vals(xr, alive)
    return ((xr - xp) * (xq - xr)) < 0.0


def tp_rank_s(xr, alive):
    """TP importance: sum of absolute neighbor deltas; non-TPs first."""
    _, _, _, xp, xq = _neighbor_vals(xr, alive)
    imp = torch.abs(xr - xp) + torch.abs(xq - xr)
    # non-turning points are removed first (the TP initial phase)
    return torch.where(_is_turning_point(xr, alive), imp,
                       -torch.ones_like(imp))


def _chord_distance(xr, alive):
    n = xr.shape[0]
    idx = torch.arange(n, dtype=torch.int32, device=xr.device)
    prev, nxt = alive_neighbors(alive)
    return torch.abs(interpolate_at(xr, prev, nxt, idx) - xr)


def tp_rank_m(xr, alive):
    """TP importance: MAE the removal would introduce; non-TPs first."""
    imp = _chord_distance(xr, alive)
    return torch.where(_is_turning_point(xr, alive), imp,
                       -torch.ones_like(imp))


def pip_rank_v(xr, alive):
    """Vertical distance to the alive-neighbor chord (PIPv)."""
    return _chord_distance(xr, alive)


def pip_rank_e(xr, alive):
    """Perpendicular (euclidean) distance to the alive-neighbor chord."""
    idx, prev, nxt, xp, xq = _neighbor_vals(xr, alive)
    dt = xr.dtype
    dxx = (nxt - prev).to(dt)
    dyy = xq - xp
    num = torch.abs(dyy * (idx - prev).to(dt) - dxx * (xr - xp))
    den = sqrt_rn(dxx * dxx + dyy * dyy)
    return num / torch.clamp_min(den, 1e-12)


# ---------------------------------------------------------------------------
# removal engine (rank-then-validate, exact ACF constraint)
# ---------------------------------------------------------------------------

_KEY = {torch.float64: (torch.int64, 0x7FFFFFFFFFFFFFFF, 63),
        torch.float32: (torch.int32, 0x7FFFFFFF, 31)}


def top_k_total(v: torch.Tensor, k: int):
    """``jax.lax.top_k(v, k)`` over ``v``'s last axis, in ``v``'s type: the
    k largest values under IEEE's total order (+0.0 above -0.0, +inf above
    every finite value), ties in index order.  A stable descending sort of
    the values' bits, mapped to integers that order as the total order
    does."""
    itype, mag, shift = _KEY[v.dtype]
    bits = v.view(itype)
    key = bits ^ ((bits >> shift) & mag)
    order = torch.sort(key, dim=-1, descending=True,
                       stable=True).indices[..., :k]
    return torch.gather(v, -1, order), order


def constrained_removal(x, cfg: CameoConfig, rank_fn, *, device="cuda",
                        trace=None) -> CompressResult:
    """Greedy removal by ``rank_fn`` score under the exact ACF constraint,
    on ``device`` (the card unless the caller asks for the CPU).

    The reference's device loop of rounds, with the loop on the host: a
    round ranks and picks on the device, and the host reads one small
    vector (accepted, picks, exhausted, deviation) a round to steer the
    next.  α
    (×1.1 on an accept up to ``cfg.alpha``, ×0.5 on a refusal down to
    ``1.5 / n``) and the round's pick count are formed on the host in the
    config's type, the reference's values.  ``trace``, a list, gets one
    ``(accepted, picks, deviation)`` a round, the deviation the round
    measured (accepted or not).
    """
    dev = _device(device)
    dt = cfg.tdtype()
    f = np.float64 if dt == torch.float64 else np.float32
    x = torch.as_tensor(x, dtype=dt).to(dev)
    n = x.shape[0]
    L = cfg.lags
    kap = cfg.kappa
    y = aggregate_series(x, kap)
    ny = y.shape[0]
    agg = extract_aggregates(y, L, backend=cfg.backend)
    transform = _stat_transform(cfg)
    mfn = _measure_fn(cfg)
    p0 = transform(acf_from_aggregates(agg, ny))

    if cfg.target_cr is not None:
        min_alive = max(2, int(np.ceil(n / cfg.target_cr)))
        eps = torch.full((), float("inf"), dtype=dt, device=dev)
    else:
        min_alive = 2
        eps = torch.full((), cfg.eps, dtype=dt, device=dev)
    if cfg.max_cr is not None:
        min_alive = max(min_alive, int(np.ceil(n / cfg.max_cr)))
    k_max = max(1, int(cfg.alpha * n))

    idx = torch.arange(n, dtype=torch.int32, device=dev)
    interior = (idx > 0) & (idx < n - 1)
    k_rank = torch.arange(k_max, device=dev)
    xr = x
    alive = torch.ones(n, dtype=torch.bool, device=dev)
    blocked = torch.zeros(n, dtype=torch.bool, device=dev)
    dev_ = torch.zeros((), dtype=dt, device=dev)
    alpha, alpha_cap, alpha_floor = f(cfg.alpha), f(cfg.alpha), f(1.5 / n)
    n_alive, rounds, done = n, 0, False
    while not done and rounds < cfg.max_rounds and n_alive > min_alive:
        score = rank_fn(xr, alive).to(dt)
        score = torch.where(alive & interior & ~blocked, score, float("inf"))
        k_dyn = max(1, min(int(alpha * f(n_alive)), n_alive - min_alive))
        neg_vals, sel_idx = top_k_total(-score, k_max)
        rank_ok = (k_rank < k_dyn) & torch.isfinite(neg_vals)
        sel = torch.zeros(n, dtype=torch.bool, device=dev)
        sel[sel_idx] = rank_ok
        sel = _independent_set(sel, score, alive)
        n_sel = sel.sum()

        alive_new = alive & ~sel
        xr_new = _reconstruct(x, alive_new)
        dy = _x_to_y_delta(xr_new - xr, kap)
        agg_new = apply_delta_dense(agg, y, dy, backend=cfg.backend)
        dev_new = mfn(transform(acf_from_aggregates(agg_new, ny)), p0)

        accept = (dev_new <= eps) & (n_sel > 0)
        single_fail = ~accept & (n_sel == 1)
        failed = blocked.clone()
        failed[torch.argmax(sel.to(torch.uint8))] = True
        blocked = torch.where(accept, torch.zeros_like(blocked),
                              torch.where(single_fail, failed, blocked))
        exhausted = ~torch.any(alive & ~blocked & interior)
        acc, n_picked, exh, d_new = torch.stack([
            accept.double(), n_sel.double(), exhausted.double(),
            dev_new.double()]).tolist()
        n_picked = int(n_picked)
        if trace is not None:
            trace.append((bool(acc), n_picked, d_new))
        if acc:
            xr, alive, y, agg, dev_ = xr_new, alive_new, y + dy, agg_new, \
                dev_new
            n_alive -= n_picked
            alpha = min(alpha * f(1.1), alpha_cap)
        else:
            alpha = max(alpha * f(0.5), alpha_floor)
        done = n_picked == 0 or (not acc and bool(exh))
        rounds += 1
    stat_new = transform(acf_from_aggregates(agg, ny))
    return CompressResult(
        kept=alive, xr=xr, deviation=dev_, n_kept=alive.sum(),
        iters=torch.tensor(rounds, dtype=torch.int32, device=dev),
        stat_orig=p0, stat_new=stat_new)


LINE_SIMPL_BASELINES = {
    "vw": vw_rank,
    "tps": tp_rank_s,
    "tpm": tp_rank_m,
    "pipv": pip_rank_v,
    "pipe": pip_rank_e,
}


def compress_baseline(x, cfg: CameoConfig, name: str, *, device="cuda",
                      trace=None) -> CompressResult:
    """Line-simplification baseline ``name`` (``LINE_SIMPL_BASELINES``) of
    ``x`` under ``cfg`` on ``device``; a tail remainder is trimmed so the
    length is a multiple of ``kappa``; ``trace`` as for
    :func:`constrained_removal`."""
    if name not in LINE_SIMPL_BASELINES:
        raise ValueError(f"unknown line-simplification baseline {name!r}")
    x = torch.as_tensor(x)
    if cfg.kappa > 1:
        x = x[:(x.shape[0] // cfg.kappa) * cfg.kappa]
    return constrained_removal(x, cfg, LINE_SIMPL_BASELINES[name],
                               device=device, trace=trace)
