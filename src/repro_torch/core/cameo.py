"""CAMEO: autocorrelation-preserving lossy compression (paper §4) — port
of ``repro/core/cameo.py``.

``mode="rounds"`` is the batched-greedy form: every round ranks all alive
points (Eq. 8 single-delta impacts for span-1 candidates, exact Eq. 9 rows
for wider segments in two capacity-bounded tiers), removes an independent
set of the lowest-impact candidates, applies one exact dense aggregate
update for the whole round and accepts or rejects the round against the
ε constraint.  Ranking runs in float32, the exact update and the
deviation in the configured dtype (float64 by default).  ``select``
chooses the round's prefix: ``"backoff"`` (adaptive α), ``"bisect"``
(dense prefix search) or ``"scan"`` — on the card the greedy walk of the
``prefix_devs`` kernel over the exact running reconstruction, elsewhere
the linearized slack packing, as the JAX package chooses by device.

``mode="sequential"`` is the paper's Algorithm 1: one point removed per
pop (a dense masked argmin for the heap), an exact Eq. 9 windowed update
and constraint check at pop time, and a ReHeap of the ``hops`` alive
neighbours on each side through the windowed-impact kernel.

PyTorch runs eagerly, so each loop is a Python loop over ``body``.  The
bodies have no device-side branches: every update is gated on the
``live``/``accept``/``can_remove`` masks, so a step past the loop's end is
an exact no-op.  The host reads the rounds loop's condition (with the
small-round choice, which changes the trajectory) once per round, and the
sequential loop's once per block of pops.  The JAX loop's empty-tier skip
is bit-identical to ranking the tier unconditionally, which is what the
port does.

Entry points run on the card unless the caller passes ``device="cpu"``.
The carries are JAX's tuples, in its order, so a carry can be handed
across packages (``repro_torch.convert``).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import measures as _measures
from repro_torch.core.acf import (
    acf_from_aggregates,
    aggregate_series,
    extract_aggregates,
    extract_aggregates_masked,
)
from repro_torch.core.aggregates import (
    alive_neighbors,
    apply_delta_dense,
    apply_delta_window,
    interpolate_at,
    neighbors_after_removal,
    segment_deltas,
)
from repro_torch.kernels import fused_round as _fused
from repro_torch.kernels import ops as _ops
from repro_torch.kernels import ref as _ref
from repro_torch.kernels.acf_impact import acf_impact_cuda

_NOT_PORTED = "not ported yet (ROADMAP.md, {item})"


@dataclasses.dataclass(frozen=True)
class CameoConfig:
    """Static configuration; the fields and defaults of the JAX package's
    ``CameoConfig``, with ``backend`` in ``"auto" | "cuda" | "reference"``
    (see ``kernels/ops.py``)."""

    eps: float = 0.01
    lags: int = 24
    stat: str = "acf"              # "acf" | "pacf"
    measure: str = "mae"           # see core.measures
    kappa: int = 1                 # Def. 2 tumbling-window size (mean agg)
    mode: str = "rounds"           # "rounds" | "sequential"
    # -- rounds mode --
    alpha: float = 0.10            # per-round removal fraction cap
    max_rounds: int = 400
    impact_chunk: int = 4096
    rank: str = "window"           # "window" (exact Eq. 9) | "single" (Alg. 2)
    stop_policy: str = "exhaustive"  # "exhaustive" | "first_violation"
    select: str = "backoff"        # "backoff" | "bisect" | "scan"
    bisect_probes: int = 6
    # -- sequential mode --
    hops: int = 16
    window: int = 64               # max re-interpolated span W (static)
    max_iters: Optional[int] = None
    # -- Def. 3 / halting --
    target_cr: Optional[float] = None   # minimize D s.t. CR >= target_cr
    max_cr: Optional[float] = None      # optional halt once CR reaches this
    dtype: str = "float64"
    backend: str = "auto"

    def tdtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)


class CompressResult(NamedTuple):
    kept: torch.Tensor        # bool [n] — True where the original point is kept
    xr: torch.Tensor          # float [n] — reconstruction (kept pts bit-exact)
    deviation: torch.Tensor   # scalar — exact D(S(recon), S(orig))
    n_kept: torch.Tensor      # scalar int
    iters: torch.Tensor       # rounds
    stat_orig: torch.Tensor   # [L] S of the original target series
    stat_new: torch.Tensor    # [L] S of the reconstruction's target series


# ---------------------------------------------------------------------------
# shared helpers
# ---------------------------------------------------------------------------

def _stat_transform(cfg: CameoConfig):
    return _ops._transform_fn(cfg.stat)


def _measure_fn(cfg: CameoConfig):
    return _measures.get_measure(cfg.measure)


def _device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the port runs on the card; pass "
                           "device='cpu' to run its plain path on the CPU")
    return dev


def _independent_set(sel: torch.Tensor, impact: torch.Tensor,
                     alive: torch.Tensor, prev=None, nxt=None):
    """Drop alive-adjacent picks: keep a pick iff it beats both its nearest
    selected alive neighbors under the (impact, index) order, so no two
    removed points ever share a segment endpoint."""
    n = sel.shape[0]
    idx = torch.arange(n, dtype=torch.int32, device=sel.device)
    if prev is None or nxt is None:
        prev, nxt = alive_neighbors(alive)
    inf = float("inf")
    pc, qc = torch.clamp(prev, 0, n - 1), torch.clamp(nxt, 0, n - 1)
    left_imp = torch.where(sel[pc] & (prev >= 0), impact[pc], inf)
    right_imp = torch.where(sel[qc] & (nxt <= n - 1), impact[qc], inf)
    li = torch.where(prev >= 0, prev, n)
    beats_left = (impact < left_imp) | ((impact == left_imp) & (idx < li))
    ri = torch.where(nxt <= n - 1, nxt, -1)
    beats_right = (impact < right_imp) | ((impact == right_imp) & (idx < ri))
    return sel & beats_left & beats_right


def _reconstruct(x_kept_vals: torch.Tensor, alive: torch.Tensor):
    """Full-length reconstruction: alive points keep their value, dead
    points take the line between their alive neighbors."""
    n = alive.shape[0]
    idx = torch.arange(n, dtype=torch.int32, device=alive.device)
    prev, nxt = alive_neighbors(alive)
    interp = interpolate_at(x_kept_vals, prev, nxt, idx)
    return torch.where(alive, x_kept_vals, interp)


def _x_to_y_delta(delta_x: torch.Tensor, kappa: int):
    if kappa == 1:
        return delta_x
    ny = delta_x.shape[0] // kappa
    return _ref.div_exact(delta_x.reshape(ny, kappa).sum(dim=1), kappa)


def _top_k_lowest(impact: torch.Tensor, k: int):
    """``jax.lax.top_k(-impact.astype(float32), k)``: the k largest negated
    keys, ties in index order (a stable descending sort; ``torch.topk``
    promises no tie order)."""
    vals, order = torch.sort(-impact.to(torch.float32), descending=True,
                             stable=True)
    return vals[:k], order[:k]


# ---------------------------------------------------------------------------
# rounds mode
# ---------------------------------------------------------------------------

# Fixed-capacity eviction buffers for the tiered exact ranking: spans up to
# _TIER_SMALL_W go to tier B, longer ones (up to W) to tier C.  Overflow
# ranks +inf for this round only.
_TIER_SMALL_W = 8


def _round_bucket(n: int, cfg: CameoConfig) -> int:
    """Padded length bucket for ``n`` (<= ~6% overhead, always a multiple of
    kappa)."""
    step = max(64, (1 << max(1, int(n - 1).bit_length())) // 16)
    nb = -(-n // step) * step
    if cfg.kappa > 1:
        nb = -(-nb // cfg.kappa) * cfg.kappa
    return nb


def _halting_params(n: int, cfg: CameoConfig):
    """(min_alive, eps) for the Def. 1/3 halting rules at true length n."""
    if cfg.target_cr is not None:
        min_alive = max(2, int(np.ceil(n / cfg.target_cr)))
        eps = np.inf
    else:
        min_alive = 2
        eps = float(cfg.eps)
    if cfg.max_cr is not None:
        min_alive = max(min_alive, int(np.ceil(n / cfg.max_cr)))
    return min_alive, eps


def _check_supported(cfg: CameoConfig) -> None:
    if cfg.mode not in ("rounds", "sequential"):
        raise ValueError(f"unknown mode {cfg.mode!r}")
    if cfg.select not in ("backoff", "bisect", "scan"):
        raise ValueError(f"unknown select {cfg.select!r}")
    if cfg.rank not in ("window", "single"):
        raise ValueError(f"unknown rank {cfg.rank!r}")


def _round_fns(cfg: CameoConfig, nb: int, n_valid: torch.Tensor,
               min_alive: torch.Tensor, eps: torch.Tensor, p0: torch.Tensor,
               prefix_devs_fn=None):
    """``(probe, body)`` closures for the rounds loop at bucket size ``nb``.

    ``probe(carry)`` is a 2-element bool tensor ``[go, small]``: the loop
    condition and the small-round choice, for the host to read in one copy.
    ``body(carry, small)`` runs one round (``small`` selects the
    ``k_small`` instantiation, as JAX's ``lax.cond`` does).  ``n_valid``,
    ``min_alive`` and ``eps`` are 0-d tensors on ``p0``'s device.
    ``prefix_devs_fn`` is the prefix walk of the card's greedy scan branch
    (default the kernel, ``fused_round.prefix_devs_cuda``).
    """
    if prefix_devs_fn is None:
        prefix_devs_fn = _fused.prefix_devs_cuda
    _check_supported(cfg)
    dt = cfg.tdtype()
    dev = p0.device
    L = cfg.lags
    kap = cfg.kappa
    W = cfg.window
    idx = torch.arange(nb, dtype=torch.int32, device=dev)
    inf = float("inf")

    n_valid = n_valid.to(torch.int32)
    validm = idx < n_valid
    ny_valid = n_valid // kap

    transform = _stat_transform(cfg)
    mfn = _measure_fn(cfg)
    use_kernel = _ops._kernel_eligible(cfg.backend, cfg.stat, cfg.measure,
                                       dev)

    # Ranking runs in float32: it only orders the heuristic selection; every
    # accepted removal is re-validated by the exact dense update in dt.
    rdt = torch.float32
    p0_r = p0.to(rdt)

    def rows_dev(rows):
        if cfg.stat == "acf" and cfg.measure in _ref.KERNEL_MEASURES:
            return _ref.measure_rows(rows, p0_r, cfg.measure)
        return mfn(transform(rows), p0_r)

    k_max = max(1, min(int(cfg.alpha * nb), nb - 2))
    WB = max(2, min(_TIER_SMALL_W, W))
    cap_b = min(nb, max(24, nb // 24))
    cap_c = min(nb, max(16, nb // 48))
    k_small = max(8, min(k_max, 32))
    cap_b_s = min(cap_b, max(16, nb // 32))
    cap_c_s = min(cap_c, max(8, nb // 64))

    def k_cap_of(alpha, n_alive):
        return torch.clamp_min(torch.minimum(
            (alpha * n_alive.to(dt)).to(torch.int32),
            (n_alive - min_alive).to(torch.int32)), 1)

    def tier_impacts(mask, xr, yr, tbl_r, prev, nxt, Wt, cap):
        """Eq. 9 ranking impacts for the first ``cap`` mask positions; +inf
        elsewhere.  Returns (impact [nb], ranked-mask [nb])."""
        taken = torch.cumsum(mask.to(torch.int32), dim=0, dtype=torch.int32)
        ranked = mask & (taken <= cap)
        # first cap true indices in index order, via a rank scatter; slot
        # `cap` takes every unranked write (JAX drops them) and is cut off,
        # unfilled slots read nb and are dropped on the write-back below.
        slots = torch.full((cap + 1,), nb, dtype=torch.int32, device=dev)
        slots[torch.where(ranked, taken - 1, cap).long()] = idx
        slots = slots[:cap]
        cand = torch.clamp(slots, 0, nb - 1)
        dwin, start, _ = segment_deltas(xr, prev, nxt, cand, Wt)
        dyw, ystart = _ops.x_window_to_y(cfg, dwin, start)
        dyw = dyw.to(rdt).contiguous()
        if use_kernel:
            imp = _fused.window_rows_cuda(
                yr, dyw, ystart.contiguous(), tbl_r, ny_valid, p0_r, L=L,
                measure=cfg.measure).to(dt)
        else:
            imp = rows_dev(_fused.window_acf_rows(
                yr, dyw, ystart, tbl_r, ny_valid, L=L)).to(dt)
        full = torch.full((nb + 1,), inf, dtype=dt, device=dev)
        full[slots.long()] = imp
        return full[:nb], ranked

    def single_impacts(xr, yr, tbl_r, prev, nxt):
        """Eq. 8 single-delta impacts for every point (exact at span 1)."""
        xhat = interpolate_at(xr, prev, nxt, idx)
        dx = xhat - xr
        dval = (dx if kap == 1 else _ref.div_exact(dx, kap)).to(rdt)
        if use_kernel:
            return acf_impact_cuda(yr, dval, tbl_r, p0_r, L=L,
                                   measure=cfg.measure, ny=ny_valid,
                                   kappa=kap).to(dt)
        rows = _ref.acf_after_single_delta(tbl_r, yr, idx // kap, dval,
                                           ny=ny_valid)
        return rows_dev(rows).to(dt)

    def probe(c):
        (xr, alive, prev, nxt, y, tbl, alpha, dev_, rounds, done, blocked,
         retried, saw_c) = c
        n_alive = torch.sum(alive)
        go = (~done) & (rounds < cfg.max_rounds) & (n_alive > min_alive)
        small = k_cap_of(alpha, n_alive) <= k_small
        return torch.stack([go, small])

    def body(c, small: bool = False):
        (xr, alive, prev, nxt, y, tbl, alpha, dev_, rounds, done, blocked,
         retried, saw_c) = c
        n_alive = torch.sum(alive)
        # gating on `live` makes a round past the loop's end an exact no-op
        live = (~done) & (rounds < cfg.max_rounds) & (n_alive > min_alive)

        removable = alive & (idx > 0) & (idx < n_valid - 1)
        cand = removable & (~blocked)
        span = nxt - prev - 1
        if cfg.rank != "single" and WB < W:
            saw_c = saw_c | (live & torch.any(
                cand & (span > WB) & (span <= W)))

        y_r = y.to(rdt)
        tbl_r = tbl.to(rdt)
        imp_sd = single_impacts(xr, y_r, tbl_r, prev, nxt)
        k_cap = k_cap_of(alpha, n_alive)

        def dense_apply(sel_idx_a, take):
            """Authoritative dense evaluation of removing the rank positions
            marked in ``take``."""
            sel = torch.zeros((nb,), dtype=torch.bool, device=dev)
            sel[sel_idx_a] = take
            alive_new = alive & (~sel)
            # independent set: post-removal neighbors by one pointer jump,
            # and one interpolation pass reproduces _reconstruct exactly
            prev_n, nxt_n = neighbors_after_removal(prev, nxt, sel)
            interp = interpolate_at(xr, prev_n, nxt_n, idx)
            xr_new = torch.where(validm, torch.where(alive_new, xr, interp),
                                 0.0)
            dy = _x_to_y_delta(xr_new - xr, kap)
            tbl_new = apply_delta_dense(tbl, y, dy, ny=ny_valid)
            dev_new = mfn(transform(acf_from_aggregates(tbl_new, ny_valid)),
                          p0)
            return dev_new, sel, alive_new, xr_new, dy, tbl_new, prev_n, nxt_n

        def linearized_pack(sel_idx, ok, dyw_k, ystart_k):
            """Linearized slack packing (the JAX package's off-TPU branch):
            score each survivor by the directional derivative of the
            deviation along its solo aggregate delta, sort by that marginal
            and search, with at most 4 dense probes, for the largest prefix
            of that order that the dense update accepts."""
            k_rows = sel_idx.shape[0]
            ar0 = torch.arange(k_rows, dtype=torch.int32, device=dev)
            gtbl = _deviation_grad(cfg, tbl, ny_valid, p0)
            dagg = _fused.solo_moment_rows(y, dyw_k, ystart_k, ny_valid, L=L)
            g = torch.einsum("al,kal->k", gtbl, dagg)
            gi = torch.where(ok, g, inf)
            order = torch.argsort(gi, stable=True)
            gs = gi[order]
            finite_g = torch.isfinite(gs)
            pred = dev_ + torch.cumsum(torch.where(finite_g, gs, 0.0), dim=0)
            kidx = ar0 + 1
            rank_pos = torch.zeros((k_rows,), dtype=torch.int32, device=dev)
            rank_pos[order] = ar0
            zero = torch.zeros((), dtype=torch.int32, device=dev)
            k_lo, k_hi = zero, torch.sum(finite_g).to(torch.int32) + 1
            err = torch.zeros((), dtype=dt, device=dev)
            out_lo = (dev_, torch.zeros((nb,), dtype=torch.bool, device=dev),
                      alive, xr, torch.zeros((nb // kap,), dtype=dt,
                                             device=dev), tbl, prev, nxt)
            # bracketed Newton search: each probe calibrates the
            # linearization bias err and proposes the largest prefix that
            # fits the corrected budget, clipped into the open bracket
            for _ in range(4):
                if not bool(k_hi - k_lo > 1):
                    break
                k_p = torch.amax(torch.where(finite_g & (pred + err <= eps),
                                             kidx, zero))
                k_p = torch.clamp(k_p, k_lo + 1, k_hi - 1)
                out_p = dense_apply(sel_idx, ok & (rank_pos < k_p))
                fits = out_p[0] <= eps
                err = out_p[0] - pred[torch.clamp_min(k_p - 1, 0)]
                out_lo = tuple(torch.where(fits, a, b)
                               for a, b in zip(out_p, out_lo))
                k_lo = torch.where(fits, k_p, k_lo)
                k_hi = torch.where(fits, k_hi, k_p)
            return out_lo, k_lo == 0

        def round_at(k_rows: int, cb: int, cc: int):
            if cfg.rank == "single":
                impact = torch.where(cand, imp_sd, inf)
                exact_ranked = cand & (span == 1)
                overflowed = torch.zeros((nb,), dtype=torch.bool, device=dev)
            else:
                a_mask = cand & (span == 1)
                b_mask = cand & (span >= 2) & (span <= WB)
                imp_b, ranked_b = tier_impacts(
                    b_mask, xr, y_r, tbl_r, prev, nxt, WB, cb)
                impact = torch.where(a_mask, imp_sd, inf)
                impact = torch.where(b_mask, imp_b, impact)
                exact_ranked = a_mask | (b_mask & ranked_b)
                overflowed = b_mask & (~ranked_b)
                if WB < W:
                    c_mask = cand & (span > WB) & (span <= W)
                    imp_c, ranked_c = tier_impacts(
                        c_mask, xr, y_r, tbl_r, prev, nxt, W, cc)
                    impact = torch.where(c_mask, imp_c, impact)
                    exact_ranked = exact_ranked | (c_mask & ranked_c)
                    overflowed = overflowed | (c_mask & (~ranked_c))
                # Overgrown segments (span > W) stay unremovable under a
                # finite eps; in the Def. 3 regime (eps = inf) they rank
                # behind a large penalty, ordered by the Eq. 8 estimate.
                over_mask = cand & (span > W)
                over_val = torch.where(torch.isfinite(eps), inf, 1e30 + imp_sd)
                impact = torch.where(over_mask, over_val, impact)

            neg_vals, sel_idx = _top_k_lowest(impact, k_rows)
            finite = torch.isfinite(-neg_vals)
            ar0 = torch.arange(k_rows, device=dev)
            rank_ok = finite & (ar0 < k_cap)
            sel_all = torch.zeros((nb,), dtype=torch.bool, device=dev)
            sel_all[sel_idx] = rank_ok
            sel_surv = _independent_set(sel_all, impact, alive, prev, nxt)
            # survival is prefix-independent under the (impact, idx) order,
            # so one pass serves every prefix the selection may choose
            ok = sel_surv[sel_idx] & rank_ok

            if cfg.select == "scan":
                dwin_k, start_k, _ = segment_deltas(xr, prev, nxt, sel_idx, W)
                dyw_k, ystart_k = _ops.x_window_to_y(cfg, dwin_k, start_k)
                if use_kernel:
                    # the greedy walk on the exact running reconstruction
                    # (the TPU's branch); the dense check gates the round,
                    # with the feasible prefix as the fallback proposal
                    take_g, take_pre, more = greedy_take(
                        prefix_devs_fn, y, dyw_k.contiguous(),
                        ystart_k.to(torch.int32).contiguous(), ok, tbl, p0,
                        ny_valid.reshape(1), eps.reshape(1), L=L,
                        measure=cfg.measure)
                    out_a = dense_apply(sel_idx, take_g)
                    out_b = dense_apply(sel_idx, take_pre)
                    use_a = (out_a[0] <= eps) | (~more)
                    out = tuple(torch.where(use_a, a, b)
                                for a, b in zip(out_a, out_b))
                    no_fit = ~torch.any(take_g)
                else:
                    out, no_fit = linearized_pack(sel_idx, ok, dyw_k,
                                                  ystart_k)
            elif cfg.select == "bisect":
                lo = torch.zeros((), dtype=torch.int32, device=dev)
                hi = torch.clamp_max(k_cap, k_rows)
                for _ in range(cfg.bisect_probes):
                    mid = (lo + hi + 1) // 2
                    fits = dense_apply(sel_idx, ok & (ar0 < mid))[0] <= eps
                    lo, hi = (torch.where(fits, mid, lo),
                              torch.where(fits, hi, mid - 1))
                out = dense_apply(sel_idx, ok & (ar0 < lo))
                no_fit = lo == 0
            else:                           # "backoff"
                kf = torch.clamp_max(k_cap, k_rows)
                out = dense_apply(sel_idx, ok & (ar0 < kf))
                no_fit = ~torch.any(ok)
            return out + (impact, exact_ranked, overflowed, sel_idx[:1],
                          finite[0], no_fit)

        if small and k_small < k_max:
            res = round_at(k_small, cap_b_s, cap_c_s)
        else:
            res = round_at(k_max, cap_b, cap_c)
        (dev_new, sel, alive_new, xr_new, dy, agg_new, prev_new, nxt_new,
         impact, exact_ranked, overflowed, best_idx, finite0, no_fit) = res
        n_sel = torch.sum(sel)
        any_sel = n_sel > 0
        accept = (dev_new <= eps) & any_sel & live
        reject = (~accept) & live

        was_single = n_sel <= 1
        if cfg.stop_policy == "first_violation":
            done_new = done | (live & (((~accept) & was_single) | no_fit))
            blocked_new = blocked
            retried_new = retried
        else:
            # exhaustive: a rejected round blocks every exactly-ranked
            # candidate with impact > eps (the best candidate as backstop);
            # when the pool is exhausted the blocks drop once and the
            # search retries — a second back-to-back exhaustion ends it.
            bump = blocked | (exact_ranked & (impact > eps))
            bump[best_idx] = True
            blocked_new = torch.where(reject & finite0, bump, blocked)
            avail = removable & (~blocked_new) & \
                (torch.isfinite(impact) | overflowed)
            exhausted = reject & (~torch.any(avail))
            clear_now = exhausted & (~retried)
            blocked_new = torch.where(clear_now, False, blocked_new)
            retried_new = torch.where(accept, False, retried | clear_now)
            done_new = done | (exhausted & retried)
        if cfg.select == "backoff":
            alpha_new = torch.where(
                accept, torch.clamp_max(alpha * 1.1, cfg.alpha),
                torch.clamp_min(alpha * 0.5, 1.5 / nb))
        else:
            alpha_new = alpha

        return (torch.where(accept, xr_new, xr),
                torch.where(accept, alive_new, alive),
                torch.where(accept, prev_new, prev),
                torch.where(accept, nxt_new, nxt),
                torch.where(accept, y + dy, y),
                torch.where(accept, agg_new, tbl),
                alpha_new,
                torch.where(accept, dev_new, dev_),
                rounds + live.to(torch.int32),
                done_new, blocked_new, retried_new, saw_c)

    return probe, body


def _deviation_grad(cfg: CameoConfig, tbl: torch.Tensor, ny, p0):
    """Gradient ``[5, L]`` of the deviation with respect to the moment
    table, with JAX's conventions at the kinks (``core.measures``): at
    round 0 every lag sits at ``|rho - p0| = 0``."""
    transform, mfn = _stat_transform(cfg), _measure_fn(cfg)
    with torch.enable_grad():
        t = tbl.detach().requires_grad_(True)
        dev = mfn(transform(acf_from_aggregates(t, ny)), p0)
        (g,) = torch.autograd.grad(dev, t)
    return g


def greedy_take(prefix_devs_fn, y, dyws, ystarts, ok, tbl, p0, ny, eps, *,
                L: int, measure: str):
    """The greedy scan's decisions for one round.

    ``prefix_devs_fn`` (``fused_round.prefix_devs_cuda`` on the card, or
    its plain version) walks the rank order committing each ``ok``
    candidate whose trial deviation fits ``eps``.  Returns ``take_g`` (the
    greedy's commits), ``take_pre`` (those before the first skipped ``ok``
    candidate, the fallback proposal) and ``more`` (``take_g`` holds
    candidates past that skip)."""
    devs = prefix_devs_fn(y, dyws, ystarts, ok, tbl, p0, ny, eps, L=L,
                          measure=measure, greedy=True)
    take_g = ok & (devs <= eps)
    k_rows = ok.shape[0]
    ar0 = torch.arange(k_rows, device=ok.device)
    first_skip = torch.amin(torch.where(ok & (~take_g), ar0, k_rows))
    take_pre = take_g & (ar0 < first_skip)
    more = torch.sum(take_g) > torch.sum(take_pre)
    return take_g, take_pre, more


def _run_rounds(carry, probe, body):
    """Drive the round loop: one small device-to-host read per round."""
    while True:
        go, small = probe(carry).tolist()
        if not go:
            return carry
        carry = body(carry, small=small)


def _rounds_init(xp: torch.Tensor, n_valid: torch.Tensor, cfg: CameoConfig):
    """Initial rounds carry + target stat ``p0`` for one padded series."""
    dt = cfg.tdtype()
    nb = xp.shape[0]
    idx = torch.arange(nb, dtype=torch.int32, device=xp.device)
    n_valid = n_valid.to(torch.int32)
    validm = idx < n_valid
    xp = torch.where(validm, xp.to(dt), 0.0)
    ny_valid = n_valid // cfg.kappa
    y0 = aggregate_series(xp, cfg.kappa)
    agg0 = extract_aggregates_masked(y0, cfg.lags, ny_valid,
                                     backend=cfg.backend)
    tbl0 = _ops.agg_to_table(agg0)
    p0 = _stat_transform(cfg)(acf_from_aggregates(agg0, ny_valid))
    prev0, nxt0 = alive_neighbors(validm)

    def scalar(v, dtype):
        return torch.full((), v, dtype=dtype, device=xp.device)

    carry = (xp, validm, prev0, nxt0, y0, tbl0, scalar(cfg.alpha, dt),
             scalar(0.0, dt), scalar(0, torch.int32), scalar(False, torch.bool),
             torch.zeros((nb,), dtype=torch.bool, device=xp.device),
             scalar(False, torch.bool), scalar(False, torch.bool))
    return carry, p0


def _rounds_result(carry, n_valid: torch.Tensor, p0: torch.Tensor,
                   cfg: CameoConfig) -> CompressResult:
    """Final carry → ``CompressResult``."""
    (xr, alive, _, _, _, tbl, _, dev, rounds, _, _, _, _) = carry
    ny_valid = n_valid.to(torch.int32) // cfg.kappa
    stat_new = _stat_transform(cfg)(acf_from_aggregates(tbl, ny_valid))
    return CompressResult(
        kept=alive, xr=xr, deviation=dev, n_kept=torch.sum(alive),
        iters=rounds, stat_orig=p0, stat_new=stat_new)


def compress_rounds(x, cfg: CameoConfig, *, pad_to: Optional[int] = None,
                    device="cuda") -> CompressResult:
    """Rounds-mode compression of one series on ``device``.

    The series is zero-padded to a shape bucket (``_round_bucket``) and
    compressed with its true length as a 0-d device tensor.  ``pad_to``
    forces at least that bucket.
    """
    _check_supported(cfg)
    dev = _device(device)
    dt = cfg.tdtype()
    x = torch.as_tensor(x, dtype=dt).to(dev)
    n = x.shape[0]
    if cfg.kappa > 1 and n % cfg.kappa:
        raise ValueError(f"length {n} not divisible by kappa={cfg.kappa}")
    nb = _round_bucket(max(n, int(pad_to or 0)), cfg)
    xp = F.pad(x, (0, nb - n))
    min_alive, eps = _halting_params(n, cfg)
    n_valid = torch.full((), n, dtype=torch.int32, device=dev)
    carry, p0 = _rounds_init(xp, n_valid, cfg)
    probe, body = _round_fns(
        cfg, nb, n_valid,
        torch.full((), min_alive, dtype=torch.int32, device=dev),
        torch.full((), eps, dtype=dt, device=dev), p0)
    res = _rounds_result(_run_rounds(carry, probe, body), n_valid, p0, cfg)
    if nb == n:
        return res
    return res._replace(kept=res.kept[:n], xr=res.xr[:n])


# ---------------------------------------------------------------------------
# sequential mode (paper-faithful Algorithm 1)
# ---------------------------------------------------------------------------

# Pops the host runs between two reads of the loop condition on the card
# (every pop past the end is an exact no-op); on the CPU a read is free.
_SEQ_BLOCK = 128


def _windowed_add(arr: torch.Tensor, win: torch.Tensor, st, Wn: int):
    """``arr[st + j] += win[j]`` with JAX's clamp-safe shift near the end
    (``dynamic_update_slice`` at ``clip(st, 0, size - Wn)``)."""
    size = arr.shape[0]
    offset = torch.clamp(st, 0, size - Wn)
    shift = st - offset
    k = torch.arange(Wn, device=arr.device)
    buf = torch.where(k >= shift, win[torch.clamp(k - shift, 0, Wn - 1)],
                      0.0)
    pos = offset + k
    return arr.scatter(0, pos, arr[pos] + buf)


def _collect_neighbors(alive: torch.Tensor, p, q, h: int):
    """The h + 1 alive indices walking left from ``p`` and right from ``q``
    (both included), clamped at the series ends with the duplicates the JAX
    package's pointer walk produces (0 past the left end, n - 1 past the
    right).  Computed from alive ranks instead of 2(h + 1) pointer steps:
    the walk follows the alive chain, so its k-th step is the alive point
    whose rank is k away."""
    n = alive.shape[0]
    c = torch.cumsum(alive.to(torch.int32), dim=0, dtype=torch.int32)
    k = torch.arange(h + 1, dtype=torch.int32, device=alive.device)
    rank_p = c[torch.clamp(p, 0, n - 1)]
    rank_q = c[torch.clamp(q, 0, n - 1)]
    left = torch.searchsorted(c, rank_p - k)     # rank <= 0 lands on 0
    right = torch.searchsorted(c, rank_q + k)    # past the end lands on n
    return torch.cat([left, torch.clamp(right, max=n - 1)])


def _sequential_fns(cfg: CameoConfig, n: int, p0: torch.Tensor):
    """``(probe, body)`` for the sequential loop over a series of length
    ``n``: ``probe(carry)`` is the 0-d loop condition, ``body(carry)`` one
    pop, branch-free (the apply and reject results are both formed and
    selected on ``can_remove``; a pop past the end is an exact no-op)."""
    dt = cfg.tdtype()
    dev = p0.device
    L, W, h, kap = cfg.lags, cfg.window, cfg.hops, cfg.kappa
    ny = n // kap
    Wy = W if kap == 1 else W // kap + 2
    transform = _stat_transform(cfg)
    mfn = _measure_fn(cfg)
    min_alive, eps = _halting_params(n, cfg)
    eps = torch.full((), eps, dtype=dt, device=dev)
    max_iters = cfg.max_iters if cfg.max_iters is not None else n - min_alive
    idx = torch.arange(n, dtype=torch.int32, device=dev)
    inf = float("inf")

    def probe(c):
        (xr, alive, prev, nxt, imp, tbl, y, dev_, it, done) = c
        return (~done) & (it < max_iters) & (torch.sum(alive) > min_alive)

    def body(c):
        (xr, alive, prev, nxt, imp, tbl, y, dev_, it, done) = c
        live = probe(c)
        i = torch.argmin(imp)                   # first minimum, as jnp
        best = imp[i]
        p, q = prev[i], nxt[i]
        # exact Eq. 9 trial removal of point i (segment (p, q))
        dwin, start, span = segment_deltas(xr, prev, nxt, i, W)
        dyw, ystart = _ops.x_window_to_y(cfg, dwin, start)
        tbl_t = apply_delta_window(tbl, y, dyw, ystart, W=Wy, L=L)
        dev_t = mfn(transform(acf_from_aggregates(tbl_t, ny)), p0)
        finite = torch.isfinite(best)
        valid = span <= W
        can_remove = live & finite & valid & (dev_t <= eps)
        # exhaustive: a rejected pop blocks its candidate (impact inf) until
        # a ReHeap revives it, and only an all-inf heap ends the run;
        # first_violation is the paper's literal stop
        if cfg.stop_policy == "first_violation":
            stop = (finite & valid & (dev_t > eps)) | (~finite)
        else:
            stop = ~finite
        done_new = done | (live & stop)

        # apply: remove i, re-line its segment, ReHeap h alive neighbours a
        # side through the windowed impact engine
        xr2 = _windowed_add(xr, dwin, start, W)
        alive2 = alive & (idx != i)
        prev2 = torch.where(idx == q, p, prev)
        nxt2 = torch.where(idx == p, q, nxt)
        y2 = _windowed_add(y, dyw, ystart, Wy)
        imp_rej = torch.where(idx == i, inf, imp)
        nbrs = _collect_neighbors(alive2, p, q, h)
        new_imps = _ops.window_impact_at(cfg, tbl_t, y2, xr2, prev2, nxt2,
                                         nbrs, p0)
        # duplicated neighbours carry identical values, so write order is
        # irrelevant; only alive points take an update
        imp_app = imp_rej.clone()
        imp_app[nbrs] = torch.where(alive2[nbrs], new_imps, imp_rej[nbrs])

        def pick(a, b):
            return torch.where(can_remove, a, b)
        return (pick(xr2, xr), pick(alive2, alive), pick(prev2, prev),
                pick(nxt2, nxt),
                pick(imp_app, torch.where(live, imp_rej, imp)),
                pick(tbl_t, tbl), pick(y2, y), pick(dev_t, dev_),
                it + live.to(torch.int32), done_new)

    return probe, body


def _sequential_init(x: torch.Tensor, cfg: CameoConfig):
    """Initial sequential carry (JAX's 10-tuple ``(xr, alive, prev, nxt,
    imp, agg, y, dev, it, done)``, with ``agg`` as the ``[5, L]`` table) and
    the target stat ``p0``.  The initial impacts are the Algorithm-2
    single-delta ones, exact while every segment has span 1."""
    dt = cfg.tdtype()
    n = x.shape[0]
    y0 = aggregate_series(x, cfg.kappa)
    tbl0 = _ops.agg_to_table(extract_aggregates(y0, cfg.lags,
                                                backend=cfg.backend))
    p0 = _stat_transform(cfg)(acf_from_aggregates(tbl0, y0.shape[0]))
    idx = torch.arange(n, dtype=torch.int32, device=x.device)
    alive0 = torch.ones((n,), dtype=torch.bool, device=x.device)
    imp0 = _ops.ranking_impact(cfg, tbl0, y0, x, alive0, p0, n, rank="single")

    def scalar(v, dtype):
        return torch.full((), v, dtype=dtype, device=x.device)

    carry = (x, alive0, idx - 1, idx + 1, imp0, tbl0, y0, scalar(0.0, dt),
             scalar(0, torch.int32), scalar(False, torch.bool))
    return carry, p0


def _run_sequential(carry, probe, body, block: int):
    """Drive the sequential loop, reading the condition once per ``block``
    pops."""
    while bool(probe(carry)):
        for _ in range(block):
            carry = body(carry)
    return carry


def compress_sequential(x, cfg: CameoConfig, *,
                        device="cuda") -> CompressResult:
    """Paper Algorithm 1 on ``device``: one point removed per pop (the heap
    is a dense masked argmin), an exact Eq. 9 windowed aggregate update and
    constraint check at pop time, and blocking — only the ``hops`` alive
    neighbours on each side get their impact recomputed (ReHeap)."""
    _check_supported(cfg)
    dev = _device(device)
    x = torch.as_tensor(x, dtype=cfg.tdtype()).to(dev)
    n = x.shape[0]
    carry, p0 = _sequential_init(x, cfg)
    probe, body = _sequential_fns(cfg, n, p0)
    carry = _run_sequential(carry, probe, body,
                            _SEQ_BLOCK if dev.type == "cuda" else 1)
    (xr, alive, _, _, _, tbl, y, dev_, it, _) = carry
    stat_new = _stat_transform(cfg)(acf_from_aggregates(tbl, y.shape[0]))
    return CompressResult(kept=alive, xr=xr, deviation=dev_,
                          n_kept=torch.sum(alive), iters=it, stat_orig=p0,
                          stat_new=stat_new)


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------

def compress(x, cfg: CameoConfig, *, device="cuda") -> CompressResult:
    """Compress ``x`` under ``cfg`` on ``device`` (the card unless the
    caller asks for the CPU).  Trims a tail remainder so the length is
    divisible by ``kappa``."""
    _check_supported(cfg)
    x = torch.as_tensor(x)
    if cfg.kappa > 1:
        x = x[:(x.shape[0] // cfg.kappa) * cfg.kappa]
    if cfg.mode == "sequential":
        return compress_sequential(x, cfg, device=device)
    return compress_rounds(x, cfg, device=device)


def compress_batch(xs, cfg: CameoConfig, *args, **kwargs):
    """Batched multi-series compression: not ported yet."""
    raise NotImplementedError("compress_batch is " + _NOT_PORTED.format(
        item="A1"))


def kept_points(res: CompressResult):
    """(indices, values) numpy views of the kept points."""
    kept = res.kept.cpu().numpy()
    idx = np.nonzero(kept)[0]
    vals = res.xr.cpu().numpy()[idx]
    return idx, vals


def decompress(indices, values, n: int, dtype=torch.float64,
               device="cuda") -> torch.Tensor:
    """Linear-interpolation decompression (paper §4.1): one forward pass,
    with ``jnp.interp``'s arithmetic, on ``device`` (the card unless the
    caller asks for the CPU)."""
    device = _device(device)
    xp = torch.as_tensor(indices, dtype=dtype, device=device)
    fp = torch.as_tensor(values, dtype=dtype, device=device)
    grid = torch.arange(n, dtype=dtype, device=device)
    i = torch.clamp(torch.searchsorted(xp, grid, right=True), 1,
                    xp.shape[0] - 1)
    df = fp[i] - fp[i - 1]
    dx = xp[i] - xp[i - 1]
    delta = grid - xp[i - 1]
    # jnp.interp tests |dx| <= spacing(eps); kept indices are integers, so
    # that is dx == 0
    dx0 = dx == 0
    f = torch.where(dx0, fp[i - 1],
                    fp[i - 1] + (delta / torch.where(dx0, 1.0, dx)) * df)
    f = torch.where(grid < xp[0], fp[0], f)
    return torch.where(grid > xp[-1], fp[-1], f)


def compression_ratio(res: CompressResult) -> float:
    return float(res.kept.shape[0]) / float(res.n_kept)
