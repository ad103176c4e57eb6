"""CAMEO: autocorrelation-preserving lossy compression (paper §4), rounds
mode — port of ``repro/core/cameo.py``.

``mode="rounds"`` is the batched-greedy form: every round ranks all alive
points (Eq. 8 single-delta impacts for span-1 candidates, exact Eq. 9 rows
for wider segments in two capacity-bounded tiers), removes an independent
set of the lowest-impact candidates, applies one exact dense aggregate
update for the whole round and accepts or rejects the round against the
ε constraint.  Ranking runs in float32, the exact update and the
deviation in the configured dtype (float64 by default).

PyTorch runs eagerly, so the round loop is a Python loop over ``body``.
The body has no device-side branches: every update is gated on the
``live``/``accept`` masks, as in the JAX program.  The one choice that
changes the trajectory — the small-round instantiation (``k_cap <=
k_small``) — is read by the host together with the loop condition in one
small device-to-host copy per round.  The JAX loop's empty-tier skip is
bit-identical to ranking the tier unconditionally, which is what the port
does.

Entry points run on the card unless the caller passes ``device="cpu"``.
The carry is JAX's 13-tuple, in its order, so a carry can be handed across
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
    extract_aggregates_masked,
)
from repro_torch.core.aggregates import (
    alive_neighbors,
    apply_delta_dense,
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
    mode: str = "rounds"           # "rounds" ("sequential" not ported yet)
    # -- rounds mode --
    alpha: float = 0.10            # per-round removal fraction cap
    max_rounds: int = 400
    impact_chunk: int = 4096
    rank: str = "window"           # "window" (exact Eq. 9) | "single" (Alg. 2)
    stop_policy: str = "exhaustive"  # "exhaustive" | "first_violation"
    select: str = "backoff"        # "backoff" | "bisect" ("scan" not ported)
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
    if cfg.mode == "sequential":
        raise NotImplementedError("mode='sequential' is " + _NOT_PORTED.format(
            item="A2, with acf_window_impact_pallas as B5"))
    if cfg.mode != "rounds":
        raise ValueError(f"unknown mode {cfg.mode!r}")
    if cfg.select == "scan":
        raise NotImplementedError("select='scan' is " + _NOT_PORTED.format(
            item="A1, with prefix_devs_pallas as B4"))
    if cfg.select not in ("backoff", "bisect"):
        raise ValueError(f"unknown select {cfg.select!r}")
    if cfg.rank not in ("window", "single"):
        raise ValueError(f"unknown rank {cfg.rank!r}")


def _round_fns(cfg: CameoConfig, nb: int, n_valid: torch.Tensor,
               min_alive: torch.Tensor, eps: torch.Tensor, p0: torch.Tensor):
    """``(probe, body)`` closures for the rounds loop at bucket size ``nb``.

    ``probe(carry)`` is a 2-element bool tensor ``[go, small]``: the loop
    condition and the small-round choice, for the host to read in one copy.
    ``body(carry, small)`` runs one round (``small`` selects the
    ``k_small`` instantiation, as JAX's ``lax.cond`` does).  ``n_valid``,
    ``min_alive`` and ``eps`` are 0-d tensors on ``p0``'s device.
    """
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

            if cfg.select == "bisect":
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
# public API
# ---------------------------------------------------------------------------

def compress(x, cfg: CameoConfig, *, device="cuda") -> CompressResult:
    """Compress ``x`` under ``cfg`` on ``device`` (the card unless the
    caller asks for the CPU).  Trims a tail remainder so the length is
    divisible by ``kappa``."""
    x = torch.as_tensor(x)
    if cfg.kappa > 1:
        x = x[:(x.shape[0] // cfg.kappa) * cfg.kappa]
    return compress_rounds(x, cfg, device=device)


def compress_batch(xs, cfg: CameoConfig, *args, **kwargs):
    """Batched multi-series compression: not ported yet."""
    raise NotImplementedError("compress_batch is " + _NOT_PORTED.format(
        item="A3"))


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
