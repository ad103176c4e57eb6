"""Coarse-grained parallel CAMEO (paper §4.4) on ``torch.distributed``
(port of ``repro/core/parallel.py``).

The paper partitions the series across T workers; each compresses its
partition against a local budget ``p * eps / T`` and synchronizes
aggregates lazily, with the cross-partition ``sxx_l`` overlap terms handled
separately.  The *lockstep* variant checks the global constraint every
round: the five ``[L]`` aggregates are summed over partitions each round (a
few KB), while ranking, selection and reconstruction stay partition-local.
Overlap regions are L-point halos.

Three entry points:

* :func:`compress_partitioned` — lockstep, global-array form: ``[T, m]``
  stacked partitions on one device, sums over the partition axis standing
  in for ``psum`` and array shifts for the halos.
* :func:`compress_partitioned_shardmap` — the same rounds with one
  partition a rank of a 1-D mesh (``repro_torch.sharding``): halos by
  send/recv, the aggregates' sum by an ``all_gather`` summed in rank order,
  so every rank holds the global form's bits and takes its decisions.
* :func:`compress_partitioned_local` — the paper's local-budget variant:
  independent compressions of the partitions at ``p * eps / T`` (one
  ``compress_batch``), the exact global deviation measured after merging.

Partition borders are pinned alive, so interpolation never crosses
partitions.  Both lockstep forms run one round body over a leading
partition axis (all T partitions, or this rank's one) with the
cross-partition steps behind a small interface (``_Stacked``,
``_Ranks``); the host reads one probe a round, as the rounds mode does.
Entry points run on the card unless the caller passes ``device="cpu"``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import sharding as shd
from repro_torch.core.acf import acf, acf_from_aggregates, aggregate_series
from repro_torch.core.cameo import (
    CameoConfig,
    CompressResult,
    _device,
    _independent_set,
    _measure_fn,
    _reconstruct,
    _stat_transform,
    _x_to_y_delta,
    compress_batch,
)
from repro_torch.kernels import ops as _ops
from repro_torch.kernels.ref import lane_col, take
from repro_torch.obs import OBS

# ---------------------------------------------------------------------------
# per-chunk aggregate contributions (overlap terms via right halos)
# ---------------------------------------------------------------------------


def _head_tail(csum, off, ny: int, L: int):
    """The head and tail sums of one or more chunks (a leading partition
    axis) from their prefix sums ``csum [..., m]``: the head keeps global
    positions ``<= ny - 1 - l``, the tail those ``>= l``."""
    m = csum.shape[-1]
    l = torch.arange(1, L + 1, device=csum.device)
    off = lane_col(torch.as_tensor(off, device=csum.device), csum)
    total = csum[..., -1:]
    hi = (ny - 1 - off) - l                     # local head end, may be <0/>m
    head = torch.where(hi >= 0, take(csum, torch.clamp(hi, 0, m - 1)), 0.0)
    lo = l - off
    tail = torch.where(lo <= 0, total, torch.where(
        lo >= m, 0.0, total - take(csum, torch.clamp(lo - 1, 0, m - 1))))
    return head, tail


def chunk_agg_contrib(y_c, halo_r, off, ny: int, L: int,
                      backend: str = "auto") -> torch.Tensor:
    """This chunk's contribution ``[5, L]`` (``[T, 5, L]`` for partitions
    ``y_c [T, m]``, ``halo_r [T, L]``, ``off [T]``) to the global Eq. 7
    aggregates, as a table ``(sx, sxl, sx2, sxl2, sxx)``.

    ``halo_r`` is the next chunk's first L values (zeros past the series
    end): it carries the paper's ``sxx_l(Overlap_ij)`` cross terms.
    Summing contributions over chunks yields the global aggregates: each
    lag pair (t, t + l) is owned by the chunk of t.  The prefix sums take
    ``ops.prefix_sum`` (XLA's cumsum order) and the lagged products
    ``ops.lag_dot``'s halo form, one launch for every partition.
    """
    csum, csum2 = _ops.prefix_sum(torch.stack([y_c, y_c * y_c], dim=-2),
                                  backend).unbind(-2)
    sx, sxl = _head_tail(csum, off, ny, L)
    sx2, sxl2 = _head_tail(csum2, off, ny, L)
    sxx = _ops.lag_dot(y_c, L, halo=halo_r, backend=backend)
    return torch.stack([sx, sxl, sx2, sxl2, sxx], dim=-2)


def chunk_delta_contrib(y_c, d_c, halo_y, halo_d, off, ny: int, L: int,
                        backend: str = "auto") -> torch.Tensor:
    """This chunk's contribution ``[5, L]`` (``[T, 5, L]`` for partitions)
    to the global aggregate *delta* for a dense per-chunk delta ``d_c``
    (Eq. 9 generalized across partitions).  ``halo_y``/``halo_d`` are the
    next chunk's first L old values and deltas."""
    e = d_c * (2.0 * y_c + d_c)
    cd, ce = _ops.prefix_sum(torch.stack([d_c, e], dim=-2),
                             backend).unbind(-2)
    dsx, dsxl = _head_tail(cd, off, ny, L)
    dsx2, dsxl2 = _head_tail(ce, off, ny, L)
    # new*new - old*old expanded per lag pair:
    #   d_t y_{t+l} + y_t d_{t+l} + d_t d_{t+l}  — three halo'd lagged dots
    dsxx = (_ops.lag_dot(d_c, L, b=y_c, halo=halo_y, backend=backend)
            + _ops.lag_dot(y_c, L, b=d_c, halo=halo_d, backend=backend)
            + _ops.lag_dot(d_c, L, b=d_c, halo=halo_d, backend=backend))
    return torch.stack([dsx, dsxl, dsx2, dsxl2, dsxx], dim=-2)


def _top_k_lowest_exact(impact: torch.Tensor, k: int):
    """``jax.lax.top_k(-impact, k)`` in ``impact``'s own dtype: the k
    largest negated keys over the last axis, ties in index order (a stable
    descending sort)."""
    vals, order = torch.sort(-impact, dim=-1, descending=True, stable=True)
    return vals[..., :k], order[..., :k]


def _chunk_select(impact, alive_c, k_dyn, k_max: int):
    """The round's picks of each partition (``[..., mx]``): its ``k_dyn``
    lowest finite impacts, filtered to an independent set."""
    neg_vals, sel_idx = _top_k_lowest_exact(impact, k_max)
    k = torch.arange(k_max, device=impact.device)
    rank_ok = (k < lane_col(k_dyn, neg_vals)) & torch.isfinite(-neg_vals)
    sel = torch.zeros_like(alive_c).scatter(-1, sel_idx, rank_ok)
    return _independent_set(sel, impact, alive_c)


def _plan(cfg: CameoConfig, n: int, T: int):
    mx = n // T
    kap = cfg.kappa
    my = mx // kap
    ny = n // kap
    L, W = cfg.lags, cfg.window
    if n % T or mx % kap:
        raise ValueError(f"n={n} must be divisible by T*kappa={T}*{kap}")
    if my < L + W:
        raise ValueError(
            f"partition too small: my={my} < L+W={L + W}; lower T or W")
    if cfg.target_cr is not None:
        min_alive = max(2, int(np.ceil(n / cfg.target_cr)))
        eps = float("inf")
    else:
        min_alive = 2
        eps = cfg.eps
    if cfg.max_cr is not None:
        min_alive = max(min_alive, int(np.ceil(n / cfg.max_cr)))
    k_max = max(1, int(cfg.alpha * mx))
    return mx, my, ny, min_alive, eps, k_max


# ---------------------------------------------------------------------------
# the cross-partition steps of the two lockstep forms
# ---------------------------------------------------------------------------

class _Stacked:
    """The global-array form: all T partitions ``[T, ...]`` on one device;
    halos are array shifts, sums over partitions ``shd.sum_partitions``,
    and the counts of this process's partitions are already global."""

    def __init__(self, T: int):
        self.T = T

    def right_halo(self, parts, width: int):
        nxt = torch.cat([parts[1:], torch.zeros_like(parts[:1])], 0)
        return nxt[:, :width]

    def left_halo(self, parts, width: int):
        prv = torch.cat([torch.zeros_like(parts[:1]), parts[:-1]], 0)
        return prv[:, parts.shape[1] - width:]

    def sum_parts(self, contribs):
        return shd.sum_partitions(contribs)

    def count(self, x):
        return x


class _Ranks:
    """The shard form: this rank's partition ``[1, ...]``; halos by
    send/recv, sums over partitions by ``shd.sum_over_ranks`` (the global
    form's order), counts by one ``all_reduce``."""

    def __init__(self, mesh, axis: str):
        self.mesh, self.axis = mesh, axis
        self.T = shd.axis_size(mesh, axis)

    def right_halo(self, parts, width: int):
        return shd.halo_from_next(parts, width, self.mesh, self.axis)

    def left_halo(self, parts, width: int):
        return shd.halo_from_prev(parts, width, self.mesh, self.axis)

    def sum_parts(self, contribs):
        return shd.sum_over_ranks(contribs[0], self.mesh, self.axis)

    def count(self, x):
        return shd.count_over_ranks(x, self.mesh, self.axis)


def _lockstep(xp: torch.Tensor, offs_y: torch.Tensor, cfg: CameoConfig,
              n: int, comm):
    """The lockstep rounds over the partitions ``xp [P, mx]`` (all T, or
    this rank's one) whose target offsets are ``offs_y [P]``.  Returns
    ``(xr, alive, dev, rounds, p0, stat_new)`` with ``xr`` and ``alive``
    ``[P, mx]``."""
    dt = cfg.tdtype()
    dev = xp.device
    L, W, kap = cfg.lags, cfg.window, cfg.kappa
    mx, my, ny, min_alive, eps, k_max = _plan(cfg, n, comm.T)
    transform = _stat_transform(cfg)
    mfn = _measure_fn(cfg)
    backend = cfg.backend

    def global_agg(yparts):
        return comm.sum_parts(chunk_agg_contrib(
            yparts, comm.right_halo(yparts, L), offs_y, ny, L, backend))

    yp = aggregate_series(xp, kap)
    agg = global_agg(yp)
    p0 = transform(acf_from_aggregates(agg, ny))
    P = xp.shape[0]
    xr, alive = xp, torch.ones((P, mx), dtype=torch.bool, device=dev)
    blocked = torch.zeros_like(alive)
    alpha = torch.full((), cfg.alpha, dtype=dt, device=dev)
    dev_ = torch.zeros((), dtype=dt, device=dev)
    alpha_floor = 1.5 / mx
    rounds, done, n_alive = 0, False, n
    while not done and rounds < cfg.max_rounds and n_alive > min_alive:
        hr = comm.right_halo(yp, L + W)
        y_ctx = torch.cat([comm.left_halo(yp, L), yp, hr], dim=1)
        impact = _ops.chunk_ranking_impact(cfg, agg, y_ctx, xr, alive, p0,
                                           offs_y, ny)
        impact = torch.where(blocked, float("inf"), impact)
        k_dyn = torch.clamp_min((alpha * torch.sum(alive, dim=1).to(dt))
                                .to(torch.int32), 1)
        sel = _chunk_select(impact, alive, k_dyn, k_max)

        alive_new = alive & ~sel
        xr_new = _reconstruct(xp, alive_new)
        dyp = _x_to_y_delta(xr_new - xr, kap)
        dagg = comm.sum_parts(chunk_delta_contrib(
            yp, dyp, hr[:, :L], comm.right_halo(dyp, L), offs_y, ny, L,
            backend))
        agg_new = agg + dagg
        dev_new = mfn(transform(acf_from_aggregates(agg_new, ny)), p0)

        # the round's one probe: the picks, the candidates left unblocked
        # (as blocked stands, and with this round's single pick added), the
        # points alive if it is accepted, summed over every partition;
        # then the accept test (the same bits on every rank) and alpha
        free = alive & torch.isfinite(impact) & ~blocked
        counts = comm.count(torch.stack([
            torch.sum(sel), torch.sum(free), torch.sum(free & ~sel),
            torch.sum(alive_new)]))
        n_sel, n_free, n_free_single, n_alive_new, in_budget, a = torch.cat(
            [t.to(torch.float64) for t in (counts, (dev_new <= eps)[None],
                                           alpha[None])]).tolist()
        accept = bool(in_budget) and n_sel > 0
        if OBS.enabled:
            OBS.inc("partitioned.rounds_accepted" if accept
                    else "partitioned.rounds_rejected")
            OBS.inc("partitioned.points_removed",
                    int(n_sel) if accept else 0)
            OBS.observe("partitioned.alpha", a)
            if accept:
                OBS.gauge("partitioned.last_accepted_round", rounds)
        if accept:
            blocked = torch.zeros_like(blocked)
        elif n_sel == 1:
            blocked = blocked | sel
            n_free = n_free_single
        done = n_sel == 0 or (not accept and n_free == 0)
        alpha = torch.clamp_max(alpha * 1.1, cfg.alpha) if accept \
            else torch.clamp_min(alpha * 0.5, alpha_floor)
        if accept:
            xr, alive, yp, agg, dev_ = xr_new, alive_new, yp + dyp, agg_new, \
                dev_new
            n_alive = n_alive_new
        rounds += 1
    stat_new = transform(acf_from_aggregates(agg, ny))
    return xr, alive, dev_, rounds, p0, stat_new


def _result(xr, alive, dev_, rounds, p0, stat_new) -> CompressResult:
    return CompressResult(
        kept=alive.reshape(-1), xr=xr.reshape(-1), deviation=dev_,
        n_kept=torch.sum(alive),
        iters=torch.tensor(rounds, dtype=torch.int32, device=alive.device),
        stat_orig=p0, stat_new=stat_new)


# ---------------------------------------------------------------------------
# lockstep partitioned compression — global-array form
# ---------------------------------------------------------------------------

def compress_partitioned(x, cfg: CameoConfig, T: int, *,
                         device="cuda") -> CompressResult:
    """Lockstep partitioned compression of ``x`` in T partitions, stacked
    ``[T, n / T]`` on ``device``: the global constraint checked every round
    against the partitions' summed aggregates.  ``n`` must divide by
    ``T * kappa`` and a partition hold at least ``L + W`` target points."""
    dev = _device(device)
    x = torch.as_tensor(x, dtype=cfg.tdtype()).to(dev)
    n = x.shape[0]
    mx, my, *_ = _plan(cfg, n, T)
    offs_y = torch.arange(T, dtype=torch.int32, device=dev) * my
    return _result(*_lockstep(x.reshape(T, mx), offs_y, cfg, n, _Stacked(T)))


# ---------------------------------------------------------------------------
# lockstep partitioned compression — one partition a rank
# ---------------------------------------------------------------------------

def compress_partitioned_shardmap(x, cfg: CameoConfig, mesh,
                                  axis: str = shd.DEFAULT_AXIS, *,
                                  device=None) -> CompressResult:
    """The rounds of :func:`compress_partitioned` with one partition a rank
    of the 1-D ``mesh`` (``T`` = its size along ``axis``).  Every rank
    passes the whole ``x`` and compresses its slice; halos travel by
    send/recv and the aggregates' sums are the global form's bits on every
    rank, so the ranks agree on every decision.  Every rank returns the
    full result (``kept`` and ``xr`` all-gathered).  ``device`` defaults
    to the rank's card (NCCL), or the CPU (gloo)."""
    dev = shd.mesh_device(mesh) if device is None else _device(device)
    comm = _Ranks(mesh, axis)
    x = torch.as_tensor(x, dtype=cfg.tdtype()).to(dev)
    n = x.shape[0]
    mx, my, *_ = _plan(cfg, n, comm.T)
    r = shd.axis_rank(mesh, axis)
    offs_y = torch.tensor([r * my], dtype=torch.int32, device=dev)
    xr, alive, dev_, rounds, p0, stat_new = _lockstep(
        x[r * mx:(r + 1) * mx][None], offs_y, cfg, n, comm)
    xr = shd.gather_ranks(xr[0], mesh, axis)
    alive = shd.gather_ranks(alive[0], mesh, axis)
    return _result(xr, alive, dev_, rounds, p0, stat_new)


# ---------------------------------------------------------------------------
# paper-faithful local-budget variant (§4.4 coarse-grained semantics)
# ---------------------------------------------------------------------------

def compress_partitioned_local(x, cfg: CameoConfig, T: int, p: float = 1.0,
                               *, device="cuda") -> CompressResult:
    """Independent per-partition compressions with local budget
    ``p * eps / T`` (the paper's §4.4 semantics), as one
    ``compress_batch`` of the T partitions (each lane equals its solo run).
    Reports the exact *global* deviation of the merged reconstruction
    (measured, not guaranteed, as in the paper)."""
    dev = _device(device)
    x = torch.as_tensor(x, dtype=cfg.tdtype()).to(dev)
    n = x.shape[0]
    if n % T:
        raise ValueError(f"n={n} not divisible by T={T}")
    mx = n // T
    if mx % cfg.kappa:
        raise ValueError(f"n={n} must be divisible by T*kappa={T}*"
                         f"{cfg.kappa}")
    local_cfg = dataclasses.replace(cfg, eps=cfg.eps * p / T)
    res = compress_batch(x.reshape(T, mx), local_cfg, device=dev)
    kept = res.kept.reshape(n)
    xr = res.xr.reshape(n)
    transform = _stat_transform(cfg)
    s0 = transform(acf(aggregate_series(x, cfg.kappa), cfg.lags))
    s1 = transform(acf(aggregate_series(xr, cfg.kappa), cfg.lags))
    return CompressResult(kept=kept, xr=xr, deviation=_measure_fn(cfg)(s1, s0),
                          n_kept=torch.sum(kept), iters=torch.max(res.iters),
                          stat_orig=s0, stat_new=s1)
