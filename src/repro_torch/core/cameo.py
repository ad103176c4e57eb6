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

The rounds mode has one round body, over a leading lane axis: a batch of
series (``compress_batch``, the fleet of sensors) is B lanes, one series
(``compress_rounds``) is B = 1.  Each lane computes exactly what it
computes alone, and a kernel launch serves every lane of a round's group
(see ``_run_rounds``).

Entry points run on the card unless the caller passes ``device="cpu"``.
The carries are JAX's tuples, in its order (the rounds carry with the
lane axis of JAX's batched carry), so a carry can be handed across
packages (``repro_torch.convert``).
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
from repro_torch.kernels.ref import take
from repro_torch.obs import OBS

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
    """One series' result; ``compress_batch`` gives every field a leading
    batch axis."""

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
    removed points ever share a segment endpoint (lane by lane over the
    last axis)."""
    n = sel.shape[-1]
    idx = torch.arange(n, dtype=torch.int32, device=sel.device)
    if prev is None or nxt is None:
        prev, nxt = alive_neighbors(alive)
    inf = float("inf")
    pc, qc = torch.clamp(prev, 0, n - 1), torch.clamp(nxt, 0, n - 1)
    left_imp = torch.where(take(sel, pc) & (prev >= 0), take(impact, pc),
                           inf)
    right_imp = torch.where(take(sel, qc) & (nxt <= n - 1), take(impact, qc),
                            inf)
    li = torch.where(prev >= 0, prev, n)
    beats_left = (impact < left_imp) | ((impact == left_imp) & (idx < li))
    ri = torch.where(nxt <= n - 1, nxt, -1)
    beats_right = (impact < right_imp) | ((impact == right_imp) & (idx < ri))
    return sel & beats_left & beats_right


def _reconstruct(x_kept_vals: torch.Tensor, alive: torch.Tensor):
    """Full-length reconstruction: alive points keep their value, dead
    points take the line between their alive neighbors."""
    n = alive.shape[-1]
    idx = torch.arange(n, dtype=torch.int32, device=alive.device)
    prev, nxt = alive_neighbors(alive)
    interp = interpolate_at(x_kept_vals, prev, nxt, idx)
    return torch.where(alive, x_kept_vals, interp)


def _x_to_y_delta(delta_x: torch.Tensor, kappa: int):
    """The target-series delta: each window's sum in XLA's row-reduce order
    (``ref.row_sum_xla``), divided by ``kappa`` exactly."""
    if kappa == 1:
        return delta_x
    ny = delta_x.shape[-1] // kappa
    return _ref.div_exact(_ref.row_sum_xla(
        delta_x.reshape(*delta_x.shape[:-1], ny, kappa)), kappa)


def _top_k_lowest(impact: torch.Tensor, k: int):
    """``jax.lax.top_k(-impact.astype(float32), k)``: the k largest negated
    keys, ties in index order (a stable descending sort over the last axis,
    which orders each lane exactly; ``torch.topk`` promises no tie
    order)."""
    vals, order = torch.sort(-impact.to(torch.float32), dim=-1,
                             descending=True, stable=True)
    return vals[..., :k], order[..., :k]


def _lane_where(cond: torch.Tensor, a: torch.Tensor, b: torch.Tensor):
    """``where`` with a per-lane condition ``cond [B]`` over ``[B, ...]``."""
    return torch.where(cond.reshape(-1, *((1,) * (a.dim() - 1))), a, b)


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
    """``(probe, body)`` closures for the rounds loop at bucket size ``nb``,
    over B lanes.

    ``n_valid`` and ``min_alive`` (int32) and ``eps`` are ``[B]`` tensors
    and ``p0`` is ``[B, L]``, all on one device.  ``probe(carry)`` is a
    ``[B, 2]`` bool tensor ``[go, small]`` a lane: the loop condition and
    the small-round choice, for the host to read in one copy (``small`` is
    False everywhere where the two instantiations coincide).
    ``body(carry, small, lanes=None)`` runs one round of the lanes in
    ``carry``: all B, or, where ``lanes`` (a device index tensor) is given,
    the carry gathered at those lanes.  ``small`` selects the ``k_small``
    instantiation for every lane of the call, as JAX's ``lax.cond`` does
    for one series.  ``prefix_devs_fn`` is the prefix walk of the card's
    greedy scan branch (default the kernel, ``fused_round.prefix_devs_cuda``).
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

    transform = _stat_transform(cfg)
    mfn = _measure_fn(cfg)
    use_kernel = _ops._kernel_eligible(cfg.backend, cfg.stat, cfg.measure,
                                       dev)
    # Ranking runs in float32: it only orders the heuristic selection; every
    # accepted removal is re-validated by the exact dense update in dt.
    rdt = torch.float32

    k_max = max(1, min(int(cfg.alpha * nb), nb - 2))
    WB = max(2, min(_TIER_SMALL_W, W))
    cap_b = min(nb, max(24, nb // 24))
    cap_c = min(nb, max(16, nb // 48))
    k_small = max(8, min(k_max, 32))
    cap_b_s = min(cap_b, max(16, nb // 32))
    cap_c_s = min(cap_c, max(8, nb // 64))
    # per-lane constants of the loop, and what the body derives from them
    n_valid = n_valid.to(torch.int32)
    consts = (n_valid, min_alive, eps, p0, idx < n_valid[:, None],
              n_valid // kap, p0.to(rdt))

    def k_cap_of(alpha, n_alive, min_alive):
        return torch.clamp_min(torch.minimum(
            (alpha * n_alive.to(dt)).to(torch.int32),
            (n_alive - min_alive).to(torch.int32)), 1)

    def probe(c):
        (xr, alive, prev, nxt, y, tbl, alpha, dev_, rounds, done, blocked,
         retried, saw_c) = c
        n_alive = torch.sum(alive, dim=-1)
        go = (~done) & (rounds < cfg.max_rounds) & (n_alive > min_alive)
        small = k_cap_of(alpha, n_alive, min_alive) <= k_small
        if k_small >= k_max:
            small = torch.zeros_like(small)
        return torch.stack([go, small], dim=-1)

    def body(c, small: bool = False, lanes=None):
        if lanes is None:
            return _body(c, small, *consts)
        return _body(c, small, *(t.index_select(0, lanes) for t in consts))

    def _body(c, small, n_valid, min_alive, eps, p0, validm, ny_valid, p0_r):
        (xr, alive, prev, nxt, y, tbl, alpha, dev_, rounds, done, blocked,
         retried, saw_c) = c
        B = xr.shape[0]
        nv = n_valid[:, None]
        eps_c = eps[:, None]

        def rows_dev(rows):
            if cfg.stat == "acf" and cfg.measure in _ref.KERNEL_MEASURES:
                return _ref.measure_rows(rows, p0_r, cfg.measure)
            return mfn(transform(rows), p0_r.unsqueeze(-2))

        def tier_impacts(mask, xr, yr, tbl_r, prev, nxt, Wt, cap):
            """Eq. 9 ranking impacts for the first ``cap`` mask positions
            of each lane; +inf elsewhere.  Returns (impact [B, nb],
            ranked-mask [B, nb])."""
            taken = torch.cumsum(mask.to(torch.int32), dim=-1,
                                 dtype=torch.int32)
            ranked = mask & (taken <= cap)
            # first cap true indices in index order, via a rank scatter;
            # slot `cap` takes every unranked write (JAX drops them) and is
            # cut off, unfilled slots read nb and are dropped on the
            # write-back below.
            slots = torch.full((B, cap + 1), nb, dtype=torch.int32,
                               device=dev)
            slots.scatter_(1, torch.where(ranked, taken - 1, cap).long(),
                           idx.expand(B, nb))
            slots = slots[:, :cap]
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
            full = torch.full((B, nb + 1), inf, dtype=dt, device=dev)
            full.scatter_(1, slots.long(), imp)
            return full[:, :nb], ranked

        def single_impacts(xr, yr, tbl_r, prev, nxt):
            """Eq. 8 single-delta impacts for every point (exact at span
            1)."""
            xhat = interpolate_at(xr, prev, nxt, idx)
            dx = xhat - xr
            dval = (dx if kap == 1 else _ref.div_exact(dx, kap)).to(rdt)
            if use_kernel:
                return acf_impact_cuda(yr, dval, tbl_r, p0_r, L=L,
                                       measure=cfg.measure, ny=ny_valid,
                                       kappa=kap).to(dt)
            rows = _ref.acf_after_single_delta(tbl_r, yr, (idx // kap)[None],
                                               dval, ny=ny_valid)
            return rows_dev(rows).to(dt)

        n_alive = torch.sum(alive, dim=-1)
        # gating on `live` makes a round past the loop's end an exact no-op
        live = (~done) & (rounds < cfg.max_rounds) & (n_alive > min_alive)

        removable = alive & (idx > 0) & (idx < nv - 1)
        cand = removable & (~blocked)
        span = nxt - prev - 1
        if cfg.rank != "single" and WB < W:
            saw_c = saw_c | (live & torch.any(
                cand & (span > WB) & (span <= W), dim=-1))

        y_r = y.to(rdt)
        tbl_r = tbl.to(rdt)
        imp_sd = single_impacts(xr, y_r, tbl_r, prev, nxt)
        k_cap = k_cap_of(alpha, n_alive, min_alive)

        def dense_apply(sel_idx_a, take_):
            """Authoritative dense evaluation of removing the rank positions
            marked in ``take_`` (each lane's own)."""
            sel = torch.zeros((B, nb), dtype=torch.bool,
                              device=dev).scatter(1, sel_idx_a, take_)
            alive_new = alive & (~sel)
            # independent set: post-removal neighbors by one pointer jump,
            # and one interpolation pass reproduces _reconstruct exactly
            prev_n, nxt_n = neighbors_after_removal(prev, nxt, sel)
            interp = interpolate_at(xr, prev_n, nxt_n, idx)
            xr_new = torch.where(validm, torch.where(alive_new, xr, interp),
                                 0.0)
            dy = _x_to_y_delta(xr_new - xr, kap)
            tbl_new = apply_delta_dense(tbl, y, dy, ny=ny_valid,
                                        backend=cfg.backend)
            dev_new = mfn(transform(acf_from_aggregates(tbl_new, ny_valid)),
                          p0)
            return dev_new, sel, alive_new, xr_new, dy, tbl_new, prev_n, nxt_n

        def pick(cond, a, b):
            return tuple(_lane_where(cond, u, v) for u, v in zip(a, b))

        def linearized_pack(sel_idx, ok, dyw_k, ystart_k):
            """Linearized slack packing (the JAX package's off-TPU branch):
            score each survivor by the directional derivative of the
            deviation along its solo aggregate delta, sort by that marginal
            and search, with at most 4 dense probes, for the largest prefix
            of that order that the dense update accepts.  Each lane's
            bracket closes at its own probe, so each probe updates only the
            lanes whose bracket is still open."""
            k_rows = sel_idx.shape[-1]
            ar0 = torch.arange(k_rows, dtype=torch.int32, device=dev)
            gtbl = _deviation_grad(cfg, tbl, ny_valid, p0)
            dagg = _fused.solo_moment_rows(y, dyw_k, ystart_k, ny_valid, L=L)
            g = torch.einsum("bal,bkal->bk", gtbl, dagg)
            gi = torch.where(ok, g, inf)
            order = torch.argsort(gi, dim=-1, stable=True)
            gs = torch.gather(gi, 1, order)
            finite_g = torch.isfinite(gs)
            pred = _scan_pred(dev_, gs, finite_g, cfg.backend)
            kidx = ar0 + 1
            rank_pos = torch.zeros((B, k_rows), dtype=torch.int32,
                                   device=dev).scatter(1, order,
                                                       ar0.expand(B, k_rows))
            zero = torch.zeros((B,), dtype=torch.int32, device=dev)
            k_lo = zero
            k_hi = torch.sum(finite_g, dim=-1).to(torch.int32) + 1
            err = torch.zeros((B,), dtype=dt, device=dev)
            out_lo = (dev_, torch.zeros((B, nb), dtype=torch.bool,
                                        device=dev),
                      alive, xr, torch.zeros((B, nb // kap), dtype=dt,
                                             device=dev), tbl, prev, nxt)
            # bracketed Newton search: each probe calibrates the
            # linearization bias err and proposes the largest prefix that
            # fits the corrected budget, clipped into the open bracket
            for _ in range(4):
                open_ = k_hi - k_lo > 1
                if not bool(torch.any(open_)):
                    break
                k_p = torch.amax(torch.where(
                    finite_g & (pred + err[:, None] <= eps_c), kidx, 0),
                    dim=-1).to(torch.int32)
                k_p = torch.minimum(torch.maximum(k_p, k_lo + 1), k_hi - 1)
                out_p = dense_apply(sel_idx, ok & (rank_pos < k_p[:, None]))
                fits = open_ & (out_p[0] <= eps)
                at = torch.clamp_min(k_p - 1, 0).long()[:, None]
                err = torch.where(
                    open_, out_p[0] - torch.gather(pred, 1, at)[:, 0], err)
                out_lo = pick(fits, out_p, out_lo)
                k_lo = torch.where(fits, k_p, k_lo)
                k_hi = torch.where(open_ & ~fits, k_p, k_hi)
            return out_lo, k_lo == 0

        def round_at(k_rows: int, cb: int, cc: int):
            if cfg.rank == "single":
                impact = torch.where(cand, imp_sd, inf)
                exact_ranked = cand & (span == 1)
                overflowed = torch.zeros((B, nb), dtype=torch.bool,
                                         device=dev)
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
                over_val = torch.where(torch.isfinite(eps_c), inf,
                                       1e30 + imp_sd)
                impact = torch.where(over_mask, over_val, impact)

            neg_vals, sel_idx = _top_k_lowest(impact, k_rows)
            finite = torch.isfinite(-neg_vals)
            ar0 = torch.arange(k_rows, device=dev)
            rank_ok = finite & (ar0 < k_cap[:, None])
            sel_all = torch.zeros((B, nb), dtype=torch.bool,
                                  device=dev).scatter(1, sel_idx, rank_ok)
            sel_surv = _independent_set(sel_all, impact, alive, prev, nxt)
            # survival is prefix-independent under the (impact, idx) order,
            # so one pass serves every prefix the selection may choose
            ok = torch.gather(sel_surv, 1, sel_idx) & rank_ok

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
                        ny_valid, eps, L=L, measure=cfg.measure)
                    out_a = dense_apply(sel_idx, take_g)
                    out_b = dense_apply(sel_idx, take_pre)
                    out = pick((out_a[0] <= eps) | (~more), out_a, out_b)
                    no_fit = ~torch.any(take_g, dim=-1)
                else:
                    out, no_fit = linearized_pack(sel_idx, ok, dyw_k,
                                                  ystart_k)
            elif cfg.select == "bisect":
                lo = torch.zeros((B,), dtype=torch.int32, device=dev)
                hi = torch.clamp_max(k_cap, k_rows)
                for _ in range(cfg.bisect_probes):
                    mid = (lo + hi + 1) // 2
                    fits = dense_apply(sel_idx,
                                       ok & (ar0 < mid[:, None]))[0] <= eps
                    lo, hi = (torch.where(fits, mid, lo),
                              torch.where(fits, hi, mid - 1))
                out = dense_apply(sel_idx, ok & (ar0 < lo[:, None]))
                no_fit = lo == 0
            else:                           # "backoff"
                kf = torch.clamp_max(k_cap, k_rows)
                out = dense_apply(sel_idx, ok & (ar0 < kf[:, None]))
                no_fit = ~torch.any(ok, dim=-1)
            return out + (impact, exact_ranked, overflowed, sel_idx[:, :1],
                          finite[:, 0], no_fit)

        if small and k_small < k_max:
            res = round_at(k_small, cap_b_s, cap_c_s)
        else:
            res = round_at(k_max, cap_b, cap_c)
        (dev_new, sel, alive_new, xr_new, dy, agg_new, prev_new, nxt_new,
         impact, exact_ranked, overflowed, best_idx, finite0, no_fit) = res
        n_sel = torch.sum(sel, dim=-1)
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
            bump = (blocked | (exact_ranked & (impact > eps_c))).scatter(
                1, best_idx, True)
            blocked_new = _lane_where(reject & finite0, bump, blocked)
            avail = removable & (~blocked_new) & \
                (torch.isfinite(impact) | overflowed)
            exhausted = reject & (~torch.any(avail, dim=-1))
            clear_now = exhausted & (~retried)
            blocked_new = _lane_where(clear_now,
                                      torch.zeros_like(blocked_new),
                                      blocked_new)
            retried_new = torch.where(accept, False, retried | clear_now)
            done_new = done | (exhausted & retried)
        if cfg.select == "backoff":
            alpha_new = torch.where(
                accept, torch.clamp_max(alpha * 1.1, cfg.alpha),
                torch.clamp_min(alpha * 0.5, 1.5 / nb))
        else:
            alpha_new = alpha

        return (_lane_where(accept, xr_new, xr),
                _lane_where(accept, alive_new, alive),
                _lane_where(accept, prev_new, prev),
                _lane_where(accept, nxt_new, nxt),
                _lane_where(accept, y + dy, y),
                _lane_where(accept, agg_new, tbl),
                alpha_new,
                torch.where(accept, dev_new, dev_),
                rounds + live.to(torch.int32),
                done_new, blocked_new, retried_new, saw_c)

    return probe, body


def _deviation_grad(cfg: CameoConfig, tbl: torch.Tensor, ny, p0):
    """Gradient ``[..., 5, L]`` of the deviation with respect to the moment
    table, with JAX's conventions at the kinks (``core.measures``): at
    round 0 every lag sits at ``|rho - p0| = 0``.  For lanes it
    differentiates the sum of the lanes' deviations, which gives each lane
    its own gradient."""
    transform, mfn = _stat_transform(cfg), _measure_fn(cfg)
    with torch.enable_grad():
        t = tbl.detach().requires_grad_(True)
        dev = mfn(transform(acf_from_aggregates(t, ny)), p0)
        (g,) = torch.autograd.grad(dev.sum(), t)
    return g


def _scan_pred(dev_: torch.Tensor, gs: torch.Tensor, finite_g: torch.Tensor,
               backend: str) -> torch.Tensor:
    """The linearized branch's predicted deviation of each prefix of the
    sorted marginals ``gs [B, K]``: ``dev + cumsum(finite gs)``, the sums in
    XLA's cumsum order (``ops.prefix_sum``), the JAX reference's."""
    return dev_[:, None] + _ops.prefix_sum(torch.where(finite_g, gs, 0.0),
                                           backend)


def greedy_take(prefix_devs_fn, y, dyws, ystarts, ok, tbl, p0, ny, eps, *,
                L: int, measure: str):
    """The greedy scan's decisions for one round, lane by lane (``y [B,
    nyb]`` ... ``ny``/``eps [B]``, or one series with 1-element ``ny`` and
    ``eps``).

    ``prefix_devs_fn`` (``fused_round.prefix_devs_cuda`` on the card, or
    its plain version) walks the rank order committing each ``ok``
    candidate whose trial deviation fits ``eps``.  Returns ``take_g`` (the
    greedy's commits), ``take_pre`` (those before the first skipped ``ok``
    candidate, the fallback proposal) and ``more`` (``take_g`` holds
    candidates past that skip)."""
    devs = prefix_devs_fn(y, dyws, ystarts, ok, tbl, p0, ny, eps, L=L,
                          measure=measure, greedy=True)
    take_g = ok & (devs <= (eps[:, None] if ok.dim() == 2 else eps))
    k_rows = ok.shape[-1]
    ar0 = torch.arange(k_rows, device=ok.device)
    first_skip = torch.amin(torch.where(ok & (~take_g), ar0, k_rows),
                            dim=-1, keepdim=True)
    take_pre = take_g & (ar0 < first_skip)
    more = torch.sum(take_g, dim=-1) > torch.sum(take_pre, dim=-1)
    return take_g, take_pre, more


def _run_rounds(carry, probe, body, occupancy=None):
    """Drive the round loop over the carry's lanes.

    Each round the host reads the ``[B, 2]`` probe in one device-to-host
    copy and splits the live lanes by the branch each one's serial
    ``lax.cond`` takes: the ``k_small`` group and the ``k_max`` group.
    Where every lane is live and in one group the body runs on the whole
    carry in place; otherwise each group is gathered, run and scattered
    back, and finished lanes leave the working set.  So a round costs one
    launch of each kernel for each group, whatever B is.

    The JAX package's lane-compacted batch loop chunks rounds (8 per
    compiled call) into power-of-two lane buckets and keeps two one-way
    program switches, ``tier_c`` (replay a chunk when a lane first
    reaches tier C) and ``small`` (``"cond"`` to ``"only"``), because a
    batched ``lax.cond`` runs both branches and every new shape compiles
    anew.  The port runs eagerly: it already reads the condition once a
    round, ranks tier C unconditionally (bit-identical to the skip, see
    the module docstring) and runs each group's branch alone, and nothing
    compiles, so it needs neither the switches nor the buckets nor the
    chunking.

    ``occupancy``, a list ``[live, slots]``, if given, accumulates the
    lanes live and the lane slots launched (see :func:`_round_step`).
    """
    while True:
        carry, live = _round_step(carry, probe, body, occupancy)
        if not live:
            return carry


def _round_step(carry, probe, body, occupancy=None):
    """One round of ``_run_rounds``: ``(carry, whether any lane was
    live)``.  ``occupancy`` (``[live, slots]``) gains the round's live
    lanes and B slots for each body call (each call launches every kernel
    once, for at most the B lanes of the batch)."""
    B = carry[0].shape[0]
    groups = {}
    for lane, (go, small) in enumerate(probe(carry).tolist()):
        if go:
            groups.setdefault(bool(small), []).append(lane)
    if occupancy is not None:
        occupancy[0] += sum(len(g) for g in groups.values())
        occupancy[1] += B * len(groups)
    if len(groups) == 1 and len(next(iter(groups.values()))) == B:
        return body(carry, small=next(iter(groups))), True
    dev = carry[0].device
    for small, lanes in groups.items():
        lanes = torch.tensor(lanes, dtype=torch.long, device=dev)
        sub = body(tuple(t.index_select(0, lanes) for t in carry),
                   small=small, lanes=lanes)
        carry = tuple(t.index_copy(0, lanes, u) for t, u in zip(carry, sub))
    return carry, bool(groups)


def _rounds_init(xp: torch.Tensor, n_valid: torch.Tensor, cfg: CameoConfig):
    """Initial rounds carry + target stat ``p0 [B, L]`` for padded series
    ``xp [B, nb]`` of true lengths ``n_valid [B]``."""
    dt = cfg.tdtype()
    B, nb = xp.shape
    dev = xp.device
    idx = torch.arange(nb, dtype=torch.int32, device=dev)
    n_valid = n_valid.to(torch.int32)
    validm = idx < n_valid[:, None]
    xp = torch.where(validm, xp.to(dt), 0.0)
    ny_valid = n_valid // cfg.kappa
    y0 = aggregate_series(xp, cfg.kappa)
    agg0 = extract_aggregates_masked(y0, cfg.lags, ny_valid,
                                     backend=cfg.backend)
    tbl0 = _ops.agg_to_table(agg0)
    p0 = _stat_transform(cfg)(acf_from_aggregates(agg0, ny_valid))
    prev0, nxt0 = alive_neighbors(validm)

    def lanes(v, dtype):
        return torch.full((B,), v, dtype=dtype, device=dev)

    carry = (xp, validm, prev0, nxt0, y0, tbl0, lanes(cfg.alpha, dt),
             lanes(0.0, dt), lanes(0, torch.int32), lanes(False, torch.bool),
             torch.zeros((B, nb), dtype=torch.bool, device=dev),
             lanes(False, torch.bool), lanes(False, torch.bool))
    return carry, p0


def _rounds_result(carry, n_valid: torch.Tensor, p0: torch.Tensor,
                   cfg: CameoConfig) -> CompressResult:
    """Final carry → ``CompressResult`` with a leading lane axis."""
    (xr, alive, _, _, _, tbl, _, dev, rounds, _, _, _, _) = carry
    ny_valid = n_valid.to(torch.int32) // cfg.kappa
    stat_new = _stat_transform(cfg)(acf_from_aggregates(tbl, ny_valid))
    return CompressResult(
        kept=alive, xr=xr, deviation=dev, n_kept=torch.sum(alive, dim=-1),
        iters=rounds, stat_orig=p0, stat_new=stat_new)


def _compress_lanes(xs: torch.Tensor, cfg: CameoConfig,
                    pad_to: Optional[int],
                    observe: bool = False) -> CompressResult:
    """Rounds-mode compression of the equal-length series ``xs [B, n]``
    (already on their device), one lane each.  ``observe`` records the
    batch counters (``cameo.batch_*``) when telemetry is on."""
    dev = xs.device
    dt = cfg.tdtype()
    B, n = xs.shape
    if cfg.kappa > 1 and n % cfg.kappa:
        raise ValueError(f"length {n} not divisible by kappa={cfg.kappa}")
    nb = _round_bucket(max(n, int(pad_to or 0)), cfg)
    xp = F.pad(xs.to(dt), (0, nb - n))
    min_alive, eps = _halting_params(n, cfg)
    n_valid = torch.full((B,), n, dtype=torch.int32, device=dev)
    carry, p0 = _rounds_init(xp, n_valid, cfg)
    probe, body = _round_fns(
        cfg, nb, n_valid,
        torch.full((B,), min_alive, dtype=torch.int32, device=dev),
        torch.full((B,), eps, dtype=dt, device=dev), p0)
    occupancy = [0, 0] if observe and OBS.enabled else None
    res = _rounds_result(_run_rounds(carry, probe, body, occupancy),
                         n_valid, p0, cfg)
    if occupancy is not None:
        OBS.inc("cameo.batch_rounds_total", int(torch.sum(res.iters)))
        OBS.gauge("cameo.batch_lane_occupancy",
                  occupancy[0] / occupancy[1] if occupancy[1] else 1.0)
    if nb == n:
        return res
    return res._replace(kept=res.kept[:, :n], xr=res.xr[:, :n])


def compress_rounds(x, cfg: CameoConfig, *, pad_to: Optional[int] = None,
                    device="cuda") -> CompressResult:
    """Rounds-mode compression of one series on ``device``: the round body
    at one lane.

    The series is zero-padded to a shape bucket (``_round_bucket``) and
    compressed with its true length as a device tensor.  ``pad_to`` forces
    at least that bucket.
    """
    _check_supported(cfg)
    dev = _device(device)
    x = torch.as_tensor(x, dtype=cfg.tdtype()).to(dev)
    res = _compress_lanes(x[None], cfg, pad_to)
    return CompressResult(*(t[0] for t in res))


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


def compress_batch(xs, cfg: CameoConfig, mesh=None, *,
                   pad_to: Optional[int] = None,
                   device="cuda") -> CompressResult:
    """Batched multi-series compression — the fleet-of-sensors workload.

    ``xs`` is ``[B, n]`` (B independent series of equal length); returns a
    ``CompressResult`` whose fields carry a leading batch axis.  Built on
    the rounds mode: each lane's result equals ``compress_rounds(xs[b],
    cfg)``.  The lanes run as one round body over a lane axis
    (``_run_rounds``): a round launches each kernel once for each of its
    (at most two) lane groups, and finished lanes leave the working set.
    A tail remainder is trimmed so the length is divisible by ``kappa``;
    ``pad_to`` forces at least that shape bucket.  ``mesh`` (sharding the
    batch over devices) is not ported yet.

    With telemetry on it records the JAX package's batch counters under
    their names: ``cameo.batch_rounds_total`` (the lanes' rounds, summed)
    and the gauge ``cameo.batch_lane_occupancy``, defined on the port's
    driver as the lanes live over the lane slots launched, summed over
    rounds, where each body call (one launch of every kernel) counts B
    slots: 1.0 while every lane runs in one group, less once lanes finish
    or split into the two groups.  JAX counts the bucket slots of its
    chunked driver instead, so the two packages' values differ.
    """
    if mesh is not None:
        raise NotImplementedError(
            "compress_batch(mesh=...) is " + _NOT_PORTED.format(
                item="A7, torch.distributed"))
    xs = torch.as_tensor(xs)
    if xs.dim() != 2:
        raise ValueError(f"compress_batch wants [B, n], got "
                         f"{tuple(xs.shape)}")
    if cfg.mode != "rounds":
        raise ValueError("compress_batch batches the rounds mode; got "
                         f"mode={cfg.mode!r}")
    _check_supported(cfg)
    dev = _device(device)
    if cfg.kappa > 1:
        xs = xs[:, :(xs.shape[1] // cfg.kappa) * cfg.kappa]
    return _compress_lanes(xs.to(dtype=cfg.tdtype(), device=dev), cfg,
                           pad_to, observe=True)


class MVCompressResult(NamedTuple):
    """Multivariate compression result: one shared kept-index stream, per-
    column values re-evaluated on it (see :func:`compress_multivariate`).
    Fields hold numpy, as the JAX package's do."""

    kept: np.ndarray        # bool [n] — shared union kept mask
    xr: np.ndarray          # float [n, C] — per-column reconstructions
    deviation: float        # max per-column deviation (the stored headline)
    n_kept: int             # |union|
    iters: int              # total compressor rounds/removals across columns
    deviations: np.ndarray  # [C] exact measured per-column deviation
    col_n_kept: np.ndarray  # [C] per-column own kept counts (pre-union)


def _column_masks(X: np.ndarray, cfg: CameoConfig, eps_c: np.ndarray,
                  cols, pad_to: Optional[int] = None, device="cuda") -> tuple:
    """(masks {c: bool [n]} for the requested ``cols``, iters) — rounds mode
    batches same-eps columns through ``compress_batch``; anything else runs
    per-column ``compress``.  ``pad_to`` rides through to the rounds
    bucket."""
    masks = {}
    iters = 0
    cols = list(cols)
    if cfg.mode == "rounds":
        by_eps = {}
        for c in cols:
            by_eps.setdefault(float(eps_c[c]), []).append(c)
        for eps, group in by_eps.items():
            gcfg = dataclasses.replace(cfg, eps=eps)
            if len(group) > 1:
                res = compress_batch(X[:, group].T, gcfg, pad_to=pad_to,
                                     device=device)
                kept = res.kept.cpu().numpy()
                its = res.iters.cpu().numpy()
                for i, c in enumerate(group):
                    masks[c] = kept[i]
                    iters += int(its[i])
            else:
                res = compress_rounds(X[:, group[0]], gcfg, pad_to=pad_to,
                                      device=device)
                masks[group[0]] = res.kept.cpu().numpy()
                iters += int(res.iters)
    else:
        for c in cols:
            ccfg = dataclasses.replace(cfg, eps=float(eps_c[c]))
            res = compress(X[:, c], ccfg, device=device)
            masks[c] = res.kept.cpu().numpy()
            iters += int(res.iters)
    return masks, iters


def _union_reconstruct(x_col: np.ndarray, union: np.ndarray,
                       device="cuda") -> np.ndarray:
    """One-shot interpolation of one column on the shared index, on
    ``device``: ``_reconstruct``, the interpolation readers of the store
    see, so the measured per-column deviation is exact for them."""
    dev = _device(device)
    return _reconstruct(torch.as_tensor(x_col).to(dev),
                        torch.as_tensor(union).to(dev)).cpu().numpy()


def _column_deviation(x_col: np.ndarray, xr_col: np.ndarray,
                      cfg: CameoConfig, device="cuda") -> float:
    """Exact measured D(S(recon), S(orig)) of one column (the Eq. 7 path:
    ``extract_aggregates``, the ``lag_dot`` kernel on the card)."""
    dev = _device(device)
    transform = _stat_transform(cfg)
    mfn = _measure_fn(cfg)
    stats = []
    for col in (x_col, xr_col):
        y = aggregate_series(torch.as_tensor(col, dtype=cfg.tdtype()).to(dev),
                             cfg.kappa)
        stats.append(transform(acf_from_aggregates(
            extract_aggregates(y, cfg.lags, backend=cfg.backend),
            y.shape[0])))
    return float(mfn(stats[1], stats[0]))


def compress_multivariate(X, cfg: CameoConfig, *, eps_c=None,
                          max_retries: int = 4,
                          pad_to: Optional[int] = None,
                          device="cuda") -> MVCompressResult:
    """Compress a multivariate series ``X [n, C]`` onto one shared index.

    Every column is compressed independently (``compress_batch`` over the
    same-ε columns in rounds mode), the per-column kept masks are unioned
    into one index stream, and every column is re-evaluated on the shared
    index: its values are the original ``X[idx, c]`` at every union index.
    The per-column ε guarantee is enforced by measurement: a column whose
    exact deviation on the shared index exceeds its budget is recompressed
    at half its working budget and the union rebuilt, up to
    ``max_retries`` times; a still-violating column then keeps all of its
    points.  With ``target_cr`` there is no ε to enforce and the measured
    deviations are reported as they are.  ``eps_c`` (length C) gives each
    column its own budget (default ``cfg.eps`` for all); ``pad_to`` rides
    through to the rounds shape bucket.
    """
    X = np.asarray(X)
    if X.ndim != 2:
        raise ValueError(f"compress_multivariate wants [n, C], got {X.shape}")
    if cfg.kappa > 1:
        X = X[:(X.shape[0] // cfg.kappa) * cfg.kappa]
    n, C = X.shape
    if eps_c is None:
        budget = np.full(C, float(cfg.eps))
    else:
        budget = np.asarray(eps_c, np.float64).reshape(-1)
        if budget.shape[0] != C:
            raise ValueError(
                f"eps_c has {budget.shape[0]} budgets for {C} columns")
        if np.any(budget <= 0):
            raise ValueError("eps_c budgets must be positive")
    eps_work = budget.copy()    # halves on repair; budget stays the bar
    masks, iters = _column_masks(X, cfg, eps_work, range(C), pad_to, device)
    enforce = cfg.target_cr is None
    retries = 0
    while True:
        union = np.zeros(n, bool)
        for c in range(C):
            union |= masks[c]
        xr = np.stack([_union_reconstruct(X[:, c], union, device)
                       for c in range(C)], axis=1)
        devs = np.array([_column_deviation(X[:, c], xr[:, c], cfg, device)
                         for c in range(C)])
        bad = [c for c in range(C)
               if enforce and np.isfinite(budget[c]) and devs[c] > budget[c]
               and not masks[c].all()]
        if not bad:
            break
        if retries >= max_retries:
            if OBS.enabled:
                OBS.inc("mvar.keep_all_columns", len(bad))
            for c in bad:     # last resort: the column keeps everything
                masks[c] = np.ones(n, bool)
            continue          # keep-all columns measure deviation 0 next pass
        retries += 1
        if OBS.enabled:
            OBS.inc("mvar.repair_halvings", len(bad))
        eps_work[bad] = eps_work[bad] / 2.0
        new_masks, it = _column_masks(X, cfg, eps_work, bad, pad_to, device)
        masks.update(new_masks)
        iters += it
    if OBS.enabled:
        for c in range(C):
            if np.isfinite(budget[c]) and budget[c] > 0:
                OBS.observe("mvar.eps_headroom", float(devs[c]) / budget[c])
    # per-column counts of the masks that went into the union
    col_n_kept = np.array([int(masks[c].sum()) for c in range(C)])
    return MVCompressResult(
        kept=union, xr=xr, deviation=float(devs.max()) if C else 0.0,
        n_kept=int(union.sum()), iters=iters, deviations=devs,
        col_n_kept=col_n_kept)


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
