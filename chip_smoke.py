#!/usr/bin/env python3
"""Drive the PyTorch port of CAMEO on one NVIDIA card and check it.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) on a wrong result:

1. device — a CUDA card is required; prints ``nvidia-smi``'s name and
   power limit;
2. build — compiles the kernels of ``src/repro_torch/kernels/csrc`` with
   nvcc into ``build/repro_torch/`` and prints the seconds and the ptxas
   report;
3. kernels — each hand-written kernel against its plain PyTorch version at
   the main paths' shapes of both datasets (uk_elec: n = 18,432, L = 48;
   aus_elec: nb = 245,760 onto nyb = 5,120, kappa = 48, L = 7), every
   measure, with the tolerance stated (0 for every kernel but lag_dot,
   whose float64 sums run in another order; lag_dot also gives the same
   bits on a second call, and its cross and halo forms are held), timed
   with CUDA events (kernel, plain version and, for lag_dot, a PyTorch
   conv1d yardstick): the
   rounds mode's float32 kernels, the float64 forms of the sequential mode
   (acf_impact at init, acf_window_impact at the ReHeap's P = 50 and, off
   the driven paths, the partitioned mode's ranking chunk, P = 4,096) and
   the scan's prefix walk (prefix_devs, greedy and not, held exactly: a
   random walk over each dataset's k_max ranks, and the real lock-step
   round 3 of each dataset's scan, its arguments captured through the
   round body's hook, with K, the ok count and the interior count); the
   two Eq. 9 window kernels are held exactly too, also on a
   boundary-heavy case each (every start within L + W of either end,
   with its interior count); prefix_sum (the Eq. 7 moments' and the dense
   update's prefix sums: one row, the pair of rows the main path launches,
   and pairs of 1, 17, 4,097 and 65,537 values) held exactly to its plain
   version on the CPU (XLA's cumsum order, jnp.cumsum's bits) and timed
   beside torch.cumsum on the card; and an empty kernel, built and bound as
   the others, timed as the launch floor.  Then the kernels of the rounds
   path with a lane axis, one launch for a batch (uk_elec B = 16, aus_elec
   B = 4; lag_dot's self and cross forms, prefix_sum (the lanes' pairs of
   rows), acf_impact, window_rows; prefix_devs 2 lanes of uk_elec's random
   walk): each against its plain
   version at its tolerance and, lane by lane, bit for bit against its
   one-lane launch;
4. main paths — ``compress()`` on the card with, for each run, every
   kernel of its path launched, deviation <= eps, a from-scratch float64
   re-measure on the CPU agreeing to 1e-9, endpoints kept and kept values
   bit-exact: rounds mode (``select="backoff"``) and ``select="scan"`` at
   full width and length on uk_elec (n = 17,520, L = 48) and aus_elec
   (n = 230,688, L = 7, kappa = 48), and ``mode="sequential"`` at the
   quickstart's widths (hops 24, window 64) on uk_elec (4,096 points) and
   aus_elec (4,800).  Backoff and sequential CRs are held within 5% of the
   same call on the CPU; the scan's CR is reported beside the CPU path's
   (which runs the linearized branch, the card the greedy one) and the
   card's backoff CR.  Then the batch: ``compress_batch`` of uk_elec
   (B = 16, seeds 0..15) and aus_elec (B = 4), each lane held against its
   per-series ``compress_rounds`` on the card (kept mask, iterations and
   the deviation's bits),
   uk_elec at B = 64 timed only, and ``compress_multivariate`` of an
   uk_elec-shaped ``[17,520, 4]``; every lane and column passes the
   guarantee checks above, and a round launches acf_impact at most twice
   and window_rows at most 2 x 2 times (two lane groups), whatever B;
5. the lock-step check — a scan round on uk_elec from one carry on the
   card: the greedy branch with the prefix_devs kernel and with its plain
   version must take the same candidates; then the seconds of each phase
   and a ``{"kernels": [...]}`` line;
6. the last line, ``{"ok": true, "device": {...}}``.

The torch.profiler breakdowns of the main paths and the pass that finds
where aus_elec's card run parts from its CPU run are in
``tools/profile_paths.py``.

It imports nothing of JAX or of the JAX package.  ``run_phases`` is the
same sequence for any device and size; the CPU tests rehearse it on tiny
inputs, where the wrappers take their plain versions.
"""
from __future__ import annotations

import contextlib
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.core import cameo  # noqa: E402
from repro_torch.core.acf import (acf_from_aggregates, aggregate_series,  # noqa: E402
                                  extract_aggregates)
from repro_torch.data.synthetic import (dataset_cameo_kwargs,  # noqa: E402
                                        make_dataset)
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import acf_impact as _acf_impact  # noqa: E402
from repro_torch.kernels import acf_window_impact as _awi  # noqa: E402
from repro_torch.kernels import fused_round as _fused  # noqa: E402
from repro_torch.kernels import lag_dot as _lag_dot  # noqa: E402
from repro_torch.kernels import ops as _ops  # noqa: E402
from repro_torch.kernels import prefix_sum as _prefix_sum  # noqa: E402
from repro_torch.kernels import ref as _ref  # noqa: E402

# H100 SXM published peaks (NVIDIA data sheet, dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
FP64_FLOPS = 34e12          # FP64 outside the tensor cores
FP32_FLOPS = 67e12          # FP32 outside the tensor cores

WRAPPERS = {"lag_dot": _lag_dot.lag_dot_cuda,
            "acf_impact": _acf_impact.acf_impact_cuda,
            "window_rows": _fused.window_rows_cuda,
            "acf_window_impact": _awi.acf_window_impact_cuda,
            "prefix_devs": _fused.prefix_devs_cuda,
            "prefix_sum": _prefix_sum.prefix_sum_cuda}
SOURCES = {"lag_dot": "src/repro_torch/kernels/csrc/lag_dot.cu",
           "acf_impact": "src/repro_torch/kernels/csrc/acf_impact.cu",
           "window_rows": "src/repro_torch/kernels/csrc/window_rows.cu",
           "acf_window_impact":
               "src/repro_torch/kernels/csrc/acf_window_impact.cu",
           "prefix_devs": "src/repro_torch/kernels/csrc/prefix_devs.cu",
           "prefix_sum": "src/repro_torch/kernels/csrc/prefix_sum.cu"}
REPLACES = {"lag_dot": "src/repro/kernels/lag_dot.py:42",
            "acf_impact": "src/repro/kernels/acf_impact.py:93",
            "window_rows": "src/repro/kernels/fused_round.py:276",
            "acf_window_impact": "src/repro/kernels/acf_window_impact.py:77",
            "prefix_devs": "src/repro/kernels/fused_round.py:382",
            # XLA's jnp.cumsum, no Pallas kernel: aggregates.py:71,73 and
            # acf.py:52-53,77-78
            "prefix_sum": "src/repro/core/aggregates.py:71"}
# Each output is held to its plain version elementwise: |got - want| <=
# rtol |want| + floor max|want|.  The floor scales with the output, so an
# output of the wrong scale (zeros, say) fails whatever the inputs' size.
# Every kernel but lag_dot rounds each operation as its plain version does
# and sums in its order, so it is held exactly: the rankings and the scan's
# decisions depend on every bit.  lag_dot's float64 sums run in another
# order than the plain version's matmul: 1e-10.  prefix_sum is held
# exactly to its plain version on the CPU: both take XLA's cumsum order
# (torch.cumsum's order is another, on the card and on the CPU).
TOL = {"lag_dot": (1e-10, 1e-10), "acf_impact": (0.0, 0.0),
       "window_rows": (0.0, 0.0), "acf_window_impact": (0.0, 0.0),
       "prefix_devs": (0.0, 0.0), "prefix_sum": (0.0, 0.0)}
DATASETS = ("uk_elec", "aus_elec")
MEASURES = ("mae", "rmse", "cheb")
EPS = 1e-2
# the main paths of phase 4: (name, CameoConfig overrides, kernels the path
# launches, whether its CR is held within 5% of the CPU path's)
PATHS = {
    "rounds": (dict(), ("lag_dot", "prefix_sum", "acf_impact",
                        "window_rows"), True),
    "scan": (dict(select="scan"), ("lag_dot", "prefix_sum", "acf_impact",
                                   "window_rows", "prefix_devs"), False),
    "sequential": (dict(mode="sequential", hops=24, window=64),
                   ("lag_dot", "prefix_sum", "acf_impact",
                    "acf_window_impact"), True),
}
# the batch phase (``compress_batch``): (dataset, lanes, whether each lane
# is held against its per-series ``compress_rounds`` run on the card in the
# same call); uk_elec at B = 64 is timed only (its per-series runs would
# take ~75 s)
BATCHES = (("uk_elec", 16, True), ("aus_elec", 4, True),
           ("uk_elec", 64, False))
# ``compress_multivariate``: uk_elec-shaped columns (seeds 0..C-1)
MV_COLUMNS = 4
# phase 3's batched shapes: lanes a launch at each dataset, and the lanes of
# prefix_devs' batched random walk (uk_elec only: its plain version walks
# each lane's 1,843 ranks one op at a time, ~3.6 s a lane on the card)
KERNEL_LANES = {"uk_elec": 16, "aus_elec": 4}
PREFIX_LANES = 2
# window_rows launches a round body makes (tiers B and C); a round launches
# acf_impact once and window_rows TIERS times for each of its (at most two)
# lane groups, whatever the lanes
TIERS = 2
# the sequential mode's lengths (the quickstart's documented 4,096 points
# for uk_elec, 100 y cells of kappa = 48 for aus_elec): it pops one point
# per iteration, each a few ms of eager host dispatch on the card
SEQ_LENGTHS = {"uk_elec": 4096, "aus_elec": 4800}


class SmokeFailure(RuntimeError):
    pass


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def reset_counts() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0


def read_counts() -> dict:
    return {name: fn.launches for name, fn in WRAPPERS.items()}


def device_ms(fn, device, reps: int = 7, inner: int = 20):
    """Median device time of one call of ``fn`` in ms (CUDA events around
    ``inner`` back-to-back calls, enqueued while the card is held busy so
    host overhead does not enter); None on the CPU."""
    if device.type != "cuda":
        return None
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        torch.cuda._sleep(50_000_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def timed_once(fn, device):
    """``(fn(), ms)``: one call timed with CUDA events (None on the CPU),
    for plain versions too slow to repeat."""
    if device.type != "cuda":
        return fn(), None
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def bound_ms(nbytes: float, flops: float, peak_flops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / peak_flops
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def check_close(what: str, kname: str, got, want) -> float:
    """Hold ``got`` to ``want`` under ``TOL[kname]``; max abs error."""
    rtol, floor = TOL[kname]
    err = torch.abs(got - want)
    scale = float(torch.max(torch.abs(want)))
    require(scale > 0, f"{what}: the plain version is all zeros")
    bad = int(torch.sum(err > rtol * torch.abs(want) + floor * scale))
    worst = float(torch.max(err))
    require(bad == 0, f"{what} disagrees with its plain version: {bad} of "
                      f"{want.numel()} outputs out of tolerance, max abs "
                      f"error {worst} (max|plain| {scale})")
    return worst


# ---------------------------------------------------------------------------
# phase 3: each kernel against its plain version
# ---------------------------------------------------------------------------

def kernel_inputs(device, name: str, length=None, seed: int = 0):
    """The main path's kernel inputs at init for dataset ``name``: the
    target series ``y`` (the Def. 2 aggregate of the padded bucket), its
    Eq. 7 table and ACF, and the Eq. 8 deltas of the first round (each
    point against the line through its neighbours)."""
    cfg = cameo.CameoConfig(eps=EPS, **dataset_cameo_kwargs(name))
    x = make_dataset(name, seed=seed, length=length)
    n = (x.shape[0] // cfg.kappa) * cfg.kappa
    x = x[:n]
    nb = cameo._round_bucket(n, cfg)
    xp = np.pad(x, (0, nb - n))
    y64 = aggregate_series(torch.from_numpy(xp), cfg.kappa).to(device)
    ny = n // cfg.kappa
    agg = extract_aggregates(y64[:ny].cpu(), cfg.lags, backend="reference")
    table = torch.stack(list(agg)).to(device)
    p0 = acf_from_aggregates(table, ny)
    dx = np.zeros(nb)
    dx[1:n - 1] = 0.5 * (xp[:n - 2] + xp[2:n]) - xp[1:n - 1]
    dval = torch.from_numpy(dx / cfg.kappa).to(device)
    return cfg, n, nb, ny, y64, table, p0, dval


def prefix_sum_entry(device, name: str, x: torch.Tensor, lanes=None) -> dict:
    """prefix_sum on the rows of ``x`` (``[..., n]``, one launch) against its
    plain version on the CPU at tolerance 0, each leading index (a lane, or
    a row of a pair) against its own launch; timed beside its plain version
    and torch.cumsum on the card.  ``lanes``: the batch this launch serves,
    recorded on the entry."""
    rows = x.numel() // x.shape[-1]
    what = f"{name} prefix_sum {list(x.shape)}"
    got = _prefix_sum.prefix_sum_cuda(x)
    err = check_close(what, "prefix_sum", got, _prefix_sum.prefix_sum_plain(
        x.cpu()).to(x.device))
    if x.dim() > 1:
        require_lanes(what, got, lambda b: _prefix_sum.prefix_sum_cuda(x[b]))
    bnd, by = bound_ms(2 * x.element_size() * x.numel(), float(x.numel()),
                       FP64_FLOPS if x.dtype == torch.float64 else FP32_FLOPS)
    per = rows // (lanes or 1)
    shape = (f"B={lanes} lanes x " if lanes else "") + \
        f"{per} row{'s' if per > 1 else ''} x n={x.shape[-1]} " \
        f"{str(x.dtype)[6:]}"
    return dict(name="prefix_sum", shape=shape, max_abs_err=err,
                ms=device_ms(lambda: _prefix_sum.prefix_sum_cuda(x), device),
                plain_ms=device_ms(lambda: _prefix_sum.prefix_sum_plain(x),
                                   device),
                library_ms=device_ms(lambda: torch.cumsum(x, dim=-1), device),
                bound_ms=bnd, bound_by=by,
                **({"lanes": lanes} if lanes else {}))


# lengths of prefix_sum's pairs of rows off the datasets' shapes: one value,
# one group past XLA's 16, one value past a 4,096-value tile, and 17 tiles
# (a cluster of 8 blocks, levels above the tiles)
PREFIX_SUM_LENGTHS = (1, 17, 4097, 65537)


def phase_kernels(device, name: str, length=None) -> list:
    """Each kernel against its plain version at ``name``'s main-path
    shapes; one entry per kernel and shape (window_rows: its two tier
    launches of one full-size round together, then its boundary-heavy
    case)."""
    cfg, *_, y64, _, _, _ = kernel_inputs(device, name, length)
    L, nyb = cfg.lags, y64.shape[0]
    out = []

    # lag_dot: Eq. 7 sxx at init, float64 (the self form reads y once),
    # the same bits on a second call; and the cross and halo forms
    got = _lag_dot.lag_dot_cuda(y64, L=L)
    want = _lag_dot.lag_dot_plain(y64, L=L)
    err = check_close(f"{name} lag_dot", "lag_dot", got, want)
    require(torch.equal(_lag_dot.lag_dot_cuda(y64, L=L), got),
            f"{name} lag_dot: two calls gave different bits")
    other = torch.flip(y64, (0,)).contiguous()
    for form in ((other, None), (other, y64[:L])):
        err = max(err, check_close(
            f"{name} lag_dot ({'halo' if form[1] is not None else 'cross'})",
            "lag_dot", _lag_dot.lag_dot_cuda(y64, *form, L=L),
            _lag_dot.lag_dot_plain(y64, *form, L=L)))
    b_ext = _lag_dot.extended_operand(y64, L=L)

    def conv():
        return F.conv1d(b_ext[1:].view(1, 1, -1), y64.view(1, 1, -1)).view(-1)
    if device.type == "cuda":
        check_close(f"{name} conv1d yardstick", "lag_dot", conv(), want)
    bnd, by = bound_ms((nyb + L) * 8, 2.0 * nyb * L, FP64_FLOPS)
    out.append(dict(
        name="lag_dot", shape=f"n={nyb} L={L} float64", max_abs_err=err,
        ms=device_ms(lambda: _lag_dot.lag_dot_cuda(y64, L=L), device),
        plain_ms=device_ms(lambda: _lag_dot.lag_dot_plain(y64, L=L), device),
        library_ms=device_ms(conv, device), bound_ms=bnd, bound_by=by))

    # prefix_sum, float64: one row of y, then the pair one launch takes on
    # the main path (y and y^2 for the Eq. 7 moments at init; the dense
    # update's delta and e, of the same length, every round); off the
    # datasets' shapes, pairs of PREFIX_SUM_LENGTHS (with uk_elec)
    out.append(prefix_sum_entry(device, name, y64))
    out.append(prefix_sum_entry(device, name, torch.stack([y64, y64 * y64])))
    if name == DATASETS[0]:
        rng = np.random.default_rng(5)
        for n in PREFIX_SUM_LENGTHS:
            out.append(prefix_sum_entry(device, name, torch.from_numpy(
                rng.standard_normal((2, n))).to(device)))

    # acf_impact: Eq. 8 impacts of every point, float32 (the rounds), and
    # float64 (the sequential init)
    acf_cases = acf_impact_cases(device, name, length)
    out.append(acf_impact_entry(device, name, acf_cases[0]))

    # window_rows: Eq. 9 tier impacts at the full-size round's capacities
    # (tiers B and C together, as one round launches them), then a
    # boundary-heavy case
    tiers = [window_rows_entry(device, name, c)
             for c in window_rows_cases(device, name, length)]
    row = dict(tiers[0])
    main = tiers[:2]
    row["shape"] = " + ".join(t["shape"] for t in main)
    row["max_abs_err"] = max(t["max_abs_err"] for t in main)
    for key in ("ms", "plain_ms", "bound_ms"):
        vals = [t[key] for t in main]
        row[key] = None if None in vals else sum(vals)
    row["bound_by"] = max(main, key=lambda t: t["bound_ms"])["bound_by"]
    out.append(row)
    out += tiers[2:]
    out += [window_impact_entry(device, c)
            for c in window_impact_cases(device, name, length)]
    out.append(acf_impact_entry(device, name, acf_cases[1]))
    out += [prefix_case(device, c["label"], c["args"], c["eps"], L,
                        mixed=c["mixed"])
            for c in prefix_cases(device, name, length)]
    for r in out:
        r["dataset"] = name
    return out


def _edge_starts(rng, ny: int, W: int, L: int, n: int) -> np.ndarray:
    """``n`` window starts within L + W of either end of [0, ny - W]:
    boundary-heavy, most windows meet a head or a tail mask."""
    hi = ny - W
    return np.concatenate([
        rng.integers(0, min(L + W, hi + 1), n - n // 2),
        rng.integers(max(0, hi - L - W), hi + 1, n // 2)]).astype(np.int32)


def window_rows_cases(device, name: str, length=None) -> list:
    """window_rows' phase-3 cases at ``name``'s main-path shapes: tier B
    (spans 2..8) and tier C (9..64) at the full-size round's capacities,
    mapped onto y, with starts across the series; then a boundary-heavy
    case at tier C's shape, every start within L + Wy of either end.  Each
    holds its label, K, Wy, L, nyb, interior count and the wrapper's
    arguments."""
    cfg, _, nb, ny, y64, table, p0, dval = kernel_inputs(device, name,
                                                         length)
    L, kap = cfg.lags, cfg.kappa
    rng = np.random.default_rng(2)
    ny_t = torch.full((), ny, dtype=torch.int32, device=device)
    scale = float(torch.std(dval.float())) * kap
    W, WB = cfg.window, cameo._TIER_SMALL_W
    KB, KC = min(nb, max(24, nb // 24)), min(nb, max(16, nb // 48))
    cases = []
    for label, K, Wx, edge in (("tier B", KB, WB, False),
                               ("tier C", KC, W, False),
                               ("boundary-heavy", KC, W, True)):
        Wy = Wx if kap == 1 else Wx // kap + 2
        st = _edge_starts(rng, ny, Wy, L, K) if edge else \
            rng.integers(1, ny - Wy, K).astype(np.int32)
        starts = torch.from_numpy(st).to(device)
        dyws = torch.from_numpy(
            (rng.standard_normal((K, Wy)) * scale).astype(np.float32)
        ).to(device)
        cases.append(dict(
            label=label, K=K, Wy=Wy, L=L, nyb=y64.shape[0],
            interior=int(_ref.interior_windows(starts, Wy, L, ny).sum()),
            args=(y64.float(), dyws, starts, table.float(), ny_t,
                  p0.float())))
    return cases


def window_rows_bound(K, Wy, L, nyb):
    """Per (candidate, lag): 4 Wy for the bilinear sum, 2 for the tail
    sums, 5 to add the table, 12 for Eq. 2, 3 for the measure; per
    candidate 3 Wy for e and 2 Wy for the prefix sums of d and e.  Bytes:
    deltas, starts, the context y once, table + p0, the output."""
    return bound_ms(
        (K * Wy + K + min(nyb, K * (Wy + 2 * L)) + 6 * L + K) * 4,
        K * (L * (4.0 * Wy + 22) + 5.0 * Wy), FP32_FLOPS)


def window_rows_entry(device, name: str, c: dict) -> dict:
    """window_rows against its plain version on case ``c`` under every
    measure; one phase-3 entry, timed under mae."""
    K, Wy, L, args = c["K"], c["Wy"], c["L"], c["args"]
    err = 0.0
    for measure in MEASURES:
        err = max(err, check_close(
            f"{name} window_rows {c['label']} (K={K}, Wy={Wy}, {measure})",
            "window_rows", _fused.window_rows_cuda(*args, L=L,
                                                   measure=measure),
            _fused.window_rows_plain(*args, L=L, measure=measure)))
    bnd, by = window_rows_bound(K, Wy, L, c["nyb"])
    return dict(
        name="window_rows",
        shape=f"{c['label']}: K={K} Wy={Wy} L={L} interior={c['interior']} "
              f"float32",
        max_abs_err=err,
        ms=device_ms(lambda: _fused.window_rows_cuda(
            *args, L=L, measure="mae"), device),
        plain_ms=device_ms(lambda: _fused.window_rows_plain(
            *args, L=L, measure="mae"), device),
        library_ms=None, bound_ms=bnd, bound_by=by)


def window_impact_cases(device, name: str, length=None) -> list:
    """acf_window_impact's phase-3 cases, float64, W = 64 mapped onto y:
    the sequential ReHeap's P = 2(hops + 1) = 50 with starts across the
    series; off the driven paths, the partitioned mode's ranking chunk (P
    = impact_chunk, kappa = 1 only; no path of the port runs it yet); and a
    boundary-heavy ReHeap, every start within L + W of either end."""
    cfg, _, _, ny, y64, table, p0, _ = kernel_inputs(device, name, length)
    L, kap = cfg.lags, cfg.kappa
    rng = np.random.default_rng(3)
    W = 64 if kap == 1 else 64 // kap + 2
    scale = float(torch.std(y64[:ny])) * 0.05
    specs = [("ReHeap", 50, False)]
    if kap == 1:
        specs.append(("ranking chunk of the partitioned mode, unported: "
                      "off path", min(cfg.impact_chunk, ny), False))
    specs.append(("boundary-heavy ReHeap", 50, True))
    cases = []
    for label, P, edge in specs:
        st = _edge_starts(rng, ny, W, L, P) if edge else \
            rng.integers(0, ny - W, P).astype(np.int32)
        starts = torch.from_numpy(st).to(device)
        dw = torch.from_numpy(rng.standard_normal((P, W)) * scale).to(device)
        ctx = _ref.candidate_contexts(y64[:ny], starts, L=L, W=W)
        cases.append(dict(
            label=label, P=P, W=W, L=L, ny=ny,
            interior=int(_ref.interior_windows(starts, W, L, ny).sum()),
            args=(ctx, dw, starts, table, p0)))
    return cases


def window_impact_entry(device, c: dict) -> dict:
    """acf_window_impact against its plain version on case ``c`` under
    every measure; one phase-3 entry, timed under mae."""
    P, W, L, ny, args = c["P"], c["W"], c["L"], c["ny"], c["args"]
    err = 0.0
    for measure in MEASURES:
        kw = dict(ny=ny, L=L, measure=measure)
        err = max(err, check_close(
            f"acf_window_impact {c['label']} (P={P}, W={W}, {measure})",
            "acf_window_impact", _awi.acf_window_impact_cuda(*args, **kw),
            _awi.acf_window_impact_plain(*args, **kw)))
    kw = dict(ny=ny, L=L, measure="mae")
    bnd, by = window_impact_bound(P, W, L, 8, FP64_FLOPS)
    return dict(
        name="acf_window_impact",
        shape=f"{c['label']}: P={P} W={W} L={L} interior={c['interior']} "
              f"float64",
        max_abs_err=err,
        ms=device_ms(lambda: _awi.acf_window_impact_cuda(*args, **kw),
                     device),
        plain_ms=device_ms(lambda: _awi.acf_window_impact_plain(
            *args, **kw), device, reps=3, inner=3),
        library_ms=None, bound_ms=bnd, bound_by=by)


def launch_floor_ms(device):
    """Median device time of an empty kernel built and bound as the port's
    kernels are (csrc/launch_floor.cu): the least any launch takes."""
    if device.type != "cuda":
        return None
    fn = _build.bind("launch_floor", "launch_floor", 0, 0)

    def launch():
        _build.check(fn(torch.cuda.current_stream(device).cuda_stream),
                     "launch_floor")
    return device_ms(launch, device)


def window_impact_bound(P, W, L, item, peak):
    """Bytes: contexts, deltas, starts, table + p0, output.  Operations the
    function needs, counted as for window_rows (the head and tail masks
    select a prefix and a suffix of the window): per (candidate, lag) 4 W
    for the bilinear sum, 2 for the tail sums, 5 to add the table, 12 for
    Eq. 2, 3 for the measure; per candidate 3 W for e and 2 W for the
    prefix sums of d and e."""
    return bound_ms((P * (W + 2 * L) + P * W + 6 * L + P) * item + 4 * P,
                    P * (L * (4.0 * W + 22) + 5.0 * W), peak)


def acf_impact_cases(device, name: str, length=None) -> list:
    """acf_impact's phase-3 cases at ``name``'s main-path shapes: the
    rounds' float32 impacts of every point of the padded bucket (runtime
    ny, the i // kappa map), then the sequential init's float64 impacts
    over SEQ_LENGTHS points (random deltas).
    Each holds its label, P, L, kappa, item size, the wrapper's arguments
    and keywords (without the measure) and its bound."""
    cfg, _, nb, ny, y64, table, p0, dval = kernel_inputs(device, name,
                                                         length)
    L, kap, nyb = cfg.lags, cfg.kappa, y64.shape[0]
    rng = np.random.default_rng(1)
    ny_t = torch.full((), ny, dtype=torch.int32, device=device)
    n_seq = SEQ_LENGTHS["uk_elec" if kap == 1 else "aus_elec"]
    y_s = y64[:n_seq // kap].contiguous()
    agg_s = extract_aggregates(y_s.cpu(), L, backend="reference")
    t_s = torch.stack(list(agg_s)).to(device)
    p_s = acf_from_aggregates(t_s, y_s.shape[0])
    d_s = torch.from_numpy(rng.standard_normal(n_seq)
                           * float(torch.std(y_s)) * 0.05).to(device)
    # per (point, lag): 7 for the five moment updates, 12 for Eq. 2 with its
    # sqrt and divide, 3 for the measure; per point 3 for e = d (2 y + d).
    # Bytes: y, the deltas, table + p0, the output.
    return [
        dict(label="rounds", P=nb, L=L, kappa=kap, item=4,
             shape=f"P={nb} nyb={nyb} kappa={kap} L={L} float32",
             args=(y64.float(), dval.float(), table.float(), p0.float()),
             kw=dict(L=L, ny=ny_t, kappa=kap),
             bound=bound_ms((nyb + nb + 6 * L + nb) * 4, nb * (22.0 * L + 3),
                            FP32_FLOPS)),
        dict(label="sequential init", P=n_seq, L=L, kappa=kap, item=8,
             shape=f"P={n_seq} ny={y_s.shape[0]} kappa={kap} L={L} float64 "
                   f"(sequential init)",
             args=(y_s, d_s, t_s, p_s), kw=dict(L=L, kappa=kap),
             bound=bound_ms((y_s.shape[0] + 2 * n_seq + 6 * L) * 8,
                            n_seq * (22.0 * L + 3), FP64_FLOPS))]


def acf_impact_entry(device, name: str, c: dict) -> dict:
    """acf_impact against its plain version on case ``c`` under every
    measure (tolerance 0); one phase-3 entry, timed under mae."""
    args, kw = c["args"], c["kw"]
    err = 0.0
    for measure in MEASURES:
        err = max(err, check_close(
            f"{name} acf_impact {c['label']} ({measure})", "acf_impact",
            _acf_impact.acf_impact_cuda(*args, measure=measure, **kw),
            _acf_impact.acf_impact_plain(*args, measure=measure, **kw)))
    bnd, by = c["bound"]
    return dict(
        name="acf_impact", shape=c["shape"], max_abs_err=err,
        ms=device_ms(lambda: _acf_impact.acf_impact_cuda(
            *args, measure="mae", **kw), device),
        plain_ms=device_ms(lambda: _acf_impact.acf_impact_plain(
            *args, measure="mae", **kw), device),
        library_ms=None, bound_ms=bnd, bound_by=by)


def prefix_cases(device, name: str, length=None) -> list:
    """prefix_devs' phase-3 cases at ``name``'s shapes, float64: a random
    walk over the scan's k_max ranks (70% ok, eps at the middle of its
    prefix curve, so the greedy walk both commits and skips), then the
    arguments of the dataset's real lock-step scan round.  Each holds its
    label, the wrapper's arguments (y, dyws, ystarts, ok, table, p0, ny),
    eps and whether the greedy walk must skip too."""
    cfg, _, nb, ny, y64, table, p0, _ = kernel_inputs(device, name, length)
    L, kap = cfg.lags, cfg.kappa
    rng = np.random.default_rng(4)
    scale = float(torch.std(y64[:ny])) * 0.05
    K = max(1, min(int(cfg.alpha * nb), nb - 2))
    Wy = cfg.window if kap == 1 else cfg.window // kap + 2
    starts = torch.from_numpy(
        rng.integers(1, ny - Wy, K).astype(np.int32)).to(device)
    dyws = torch.from_numpy(rng.standard_normal((K, Wy))
                            * scale * 0.2).to(device)
    ok = torch.from_numpy(rng.random(K) > 0.3).to(device)
    ny_t = torch.full((1,), ny, dtype=torch.int32, device=device)
    args = (y64, dyws, starts, ok, table, p0, ny_t)
    curve = _fused.prefix_devs_cuda(*args, L=L, measure="mae")
    eps = torch.sort(curve).values[K // 2].reshape(1)
    cap = capture_round(device, name, length=length)
    return [dict(label="random", args=args, eps=eps, mixed=True),
            dict(label=f"real round {cap['round']}", args=cap["args"][:7],
                 eps=cap["args"][7], mixed=False)]


def prefix_bound(K, n_ok, Wy, L, nyb):
    """Bound of one prefix walk, float64.  A rank that is not ok adds a
    zero delta: its output is the committed deviation, so it needs no
    window work and no delta row, only its ok flag and its store.  Bytes:
    y, the ok ranks' delta rows and starts, the ok flags, table + p0, the
    output.  Operations per ok rank: the window-impact count at P = 1,
    plus Wy for the commit of z (the table's commit is a copy)."""
    return bound_ms((nyb + n_ok * Wy + 6 * L + K) * 8 + 4 * n_ok + K,
                    n_ok * (L * (4.0 * Wy + 22) + 6.0 * Wy), FP64_FLOPS)


def prefix_case(device, what: str, args, eps, L: int,
                mixed: bool = True) -> dict:
    """prefix_devs against its plain version on ``args`` (y, dyws, ystarts,
    ok, table, p0, ny): the curve and the greedy walk under mae, rmse and
    cheb too where K is small; one phase-3 entry, timed on the greedy mae
    call, with K and its ok and interior counts.  The greedy walk must
    commit, and skip too where ``mixed``."""
    y, dyws, starts, ok = args[:4]
    K, Wy = dyws.shape
    nyb, ny = y.shape[0], int(args[6].reshape(-1)[0])
    # the plain version walks K candidates with ~30 PyTorch ops each (16 s
    # at aus_elec's K on the card), so it runs once per case; the greedy
    # mae call is the one timed
    err, plain_ms = 0.0, None
    cases = [(False, "mae"), (True, "mae")]
    if K <= 4096:
        cases += [(True, "rmse"), (True, "cheb")]
    for greedy, measure in cases:
        kw = dict(L=L, measure=measure, greedy=greedy)
        got = _fused.prefix_devs_cuda(*args, eps, **kw)
        want, ms = timed_once(lambda: _fused.prefix_devs_plain(
            *args, eps, **kw), device)
        if (greedy, measure) == (True, "mae"):
            plain_ms = ms
        err = max(err, check_close(
            f"prefix_devs {what} (K={K}, Wy={Wy}, greedy={greedy}, "
            f"{measure})", "prefix_devs", got, want))
    take = ok & (_fused.prefix_devs_cuda(*args, eps, L=L, greedy=True)
                 <= eps)
    require(0 < int(take.sum()) and (int(take.sum()) < int(ok.sum())
                                      or not mixed),
            f"prefix_devs {what}: the greedy walk should commit"
            + (" and skip" if mixed else ""))
    s = torch.clamp(starts.long(), 0, nyb - 1)
    n_ok = int(ok.sum())
    n_int = int((ok & (s >= L) & (s + Wy + L <= ny)).sum())
    kw = dict(L=L, measure="mae", greedy=True)
    bnd, by = prefix_bound(K, n_ok, Wy, L, nyb)
    return dict(
        name="prefix_devs",
        shape=f"{what}: K={K} ok={n_ok} interior={n_int} Wy={Wy} L={L} "
              f"nyb={nyb} float64 greedy (commits {int(take.sum())})",
        K=K, ok=n_ok, interior=n_int, max_abs_err=err,
        ms=device_ms(lambda: _fused.prefix_devs_cuda(*args, eps, **kw),
                     device, reps=5, inner=5),
        plain_ms=plain_ms, library_ms=None, bound_ms=bnd, bound_by=by,
        measures=[m for g, m in cases if g])


# ---------------------------------------------------------------------------
# phase 3, lanes: the four kernels of the rounds path at a batch's shapes
# ---------------------------------------------------------------------------

def lanes_inputs(device, name: str, B: int, length=None):
    """``kernel_inputs`` of B series of ``name`` (seeds 0..B-1), stacked on
    a leading lane axis, with ``ny`` as one int32 value a lane."""
    per = [kernel_inputs(device, name, length, seed=b) for b in range(B)]
    cfg, _, nb, ny = per[0][:4]
    y64, table, p0, dval = (torch.stack([p[i] for p in per])
                            for i in (4, 5, 6, 7))
    ny_t = torch.full((B,), ny, dtype=torch.int32, device=device)
    return cfg, nb, ny, y64, table, p0, dval, ny_t


def require_lanes(what: str, got, one) -> None:
    """Each lane of a batched launch has the bits of its launch alone:
    ``one(b)`` launches lane b by itself."""
    for b in range(got.shape[0]):
        require(torch.equal(got[b], one(b)),
                f"{what}: lane {b} differs from its one-lane launch")


def _lanes_entry(name, shape, err, ms, plain_ms, bound, B, library_ms=None):
    bnd, by = bound
    return dict(name=name, shape=shape, max_abs_err=err, ms=ms,
                plain_ms=plain_ms, library_ms=library_ms, bound_ms=bnd,
                bound_by=by, lanes=B)


def phase_kernels_lanes(device, name: str, B: int, length=None,
                        prefix_lanes: int = 0) -> list:
    """lag_dot (self and cross forms), prefix_sum, acf_impact and
    window_rows (and, with ``prefix_lanes``, prefix_devs) on B lanes of
    ``name``'s main-path shapes, one launch for every lane: each against
    its plain version at its tolerance and, lane by lane, against its
    one-lane launch at tolerance 0."""
    cfg, nb, ny, y64, table, p0, dval, ny_t = lanes_inputs(device, name, B,
                                                          length)
    L, kap, nyb = cfg.lags, cfg.kappa, y64.shape[-1]
    out = []

    # lag_dot, float64 self form: [B, nyb] -> [B, L]
    got = _lag_dot.lag_dot_cuda(y64, L=L)
    err = check_close(f"{name} lag_dot B={B}", "lag_dot", got,
                      _lag_dot.lag_dot_plain(y64, L=L))
    require_lanes(f"{name} lag_dot B={B}", got,
                  lambda b: _lag_dot.lag_dot_cuda(y64[b], L=L))
    b_ext = F.pad(y64, (0, L))

    def conv():     # one grouped convolution: lane b's series against itself
        return F.conv1d(b_ext[None, :, 1:], y64[:, None, :],
                        groups=B).view(B, L)
    out.append(_lanes_entry(
        "lag_dot", f"B={B} lanes x n={nyb} L={L} float64", err,
        device_ms(lambda: _lag_dot.lag_dot_cuda(y64, L=L), device),
        device_ms(lambda: _lag_dot.lag_dot_plain(y64, L=L), device,
                  reps=3, inner=3),
        bound_ms(B * (nyb + L) * 8, B * 2.0 * nyb * L, FP64_FLOPS), B,
        device_ms(conv, device)))

    # lag_dot's cross form, the dense update's bilinear term: [B, nyb]
    # against b [B, nyb]
    other = torch.flip(y64, (-1,)).contiguous()
    got = _lag_dot.lag_dot_cuda(y64, other, L=L)
    check_close(f"{name} lag_dot B={B} (cross)", "lag_dot", got,
                _lag_dot.lag_dot_plain(y64, other, L=L))
    require_lanes(f"{name} lag_dot B={B} (cross)", got,
                  lambda b: _lag_dot.lag_dot_cuda(
                      y64[b:b + 1], other[b:b + 1], L=L)[0])

    # prefix_sum, the dense update's pair of rows of every lane: [B, 2, nyb]
    out.append(prefix_sum_entry(device, name,
                                torch.stack([y64, y64 * y64], dim=-2), B))

    # acf_impact, the rounds' float32 impacts of every point
    args = (y64.float(), dval.float(), table.float(), p0.float())
    kw = dict(L=L, ny=ny_t, kappa=kap)
    err = 0.0
    for measure in MEASURES:
        got = _acf_impact.acf_impact_cuda(*args, measure=measure, **kw)
        err = max(err, check_close(
            f"{name} acf_impact B={B} ({measure})", "acf_impact", got,
            _acf_impact.acf_impact_plain(*args, measure=measure, **kw)))
        require_lanes(f"{name} acf_impact B={B} ({measure})", got,
                      lambda b: _acf_impact.acf_impact_cuda(
                          *(a[b] for a in args), measure=measure, L=L,
                          ny=ny_t[b:b + 1], kappa=kap))
    out.append(_lanes_entry(
        "acf_impact", f"B={B} lanes x P={nb} nyb={nyb} kappa={kap} L={L} "
                      f"float32", err,
        device_ms(lambda: _acf_impact.acf_impact_cuda(
            *args, measure="mae", **kw), device),
        device_ms(lambda: _acf_impact.acf_impact_plain(
            *args, measure="mae", **kw), device, reps=3, inner=3),
        bound_ms(B * (nyb + nb + 6 * L + nb) * 4, B * nb * (22.0 * L + 3),
                 FP32_FLOPS), B))

    # window_rows, tiers B and C at the full-size round's capacities, each
    # lane its own candidates
    rng = np.random.default_rng(5)
    scale = float(torch.std(dval.float())) * kap
    W, WB = cfg.window, cameo._TIER_SMALL_W
    tiers = []
    for K, Wx in ((min(nb, max(24, nb // 24)), WB),
                  (min(nb, max(16, nb // 48)), W)):
        Wy = Wx if kap == 1 else Wx // kap + 2
        starts = torch.from_numpy(rng.integers(1, ny - Wy, (B, K)).astype(
            np.int32)).to(device)
        dyws = torch.from_numpy((rng.standard_normal((B, K, Wy)) * scale
                                 ).astype(np.float32)).to(device)
        targs = (y64.float(), dyws, starts, table.float(), ny_t, p0.float())
        err = 0.0
        for measure in MEASURES:
            got = _fused.window_rows_cuda(*targs, L=L, measure=measure)
            err = max(err, check_close(
                f"{name} window_rows B={B} (K={K}, Wy={Wy}, {measure})",
                "window_rows", got,
                _fused.window_rows_plain(*targs, L=L, measure=measure)))
            require_lanes(
                f"{name} window_rows B={B} (K={K}, Wy={Wy}, {measure})", got,
                lambda b: _fused.window_rows_cuda(
                    targs[0][b], dyws[b], starts[b], targs[3][b],
                    ny_t[b:b + 1], targs[5][b], L=L, measure=measure))
        tiers.append(dict(
            K=K, Wy=Wy, err=err,
            ms=device_ms(lambda: _fused.window_rows_cuda(
                *targs, L=L, measure="mae"), device),
            plain_ms=device_ms(lambda: _fused.window_rows_plain(
                *targs, L=L, measure="mae"), device, reps=3, inner=3),
            bound=window_rows_bound(B * K, Wy, L, B * nyb)))
    out.append(_lanes_entry(
        "window_rows", " + ".join(f"B={B} lanes x K={t['K']} Wy={t['Wy']}"
                                  for t in tiers) + f" L={L} float32",
        max(t["err"] for t in tiers),
        *[None if None in v else sum(v) for v in
          ([t["ms"] for t in tiers], [t["plain_ms"] for t in tiers])],
        (sum(t["bound"][0] for t in tiers),
         max(tiers, key=lambda t: t["bound"][0])["bound"][1]), B))

    # prefix_devs, prefix_lanes lanes of the scan's random walk (70% ok,
    # eps at the middle of each lane's prefix curve), one block a lane
    if prefix_lanes:
        Bp = prefix_lanes
        K = max(1, min(int(cfg.alpha * nb), nb - 2))
        Wy = cfg.window if kap == 1 else cfg.window // kap + 2
        sc = float(torch.std(y64[0, :ny])) * 0.05
        rng = np.random.default_rng(6)
        pargs = (y64[:Bp].contiguous(),
                 torch.from_numpy(rng.standard_normal((Bp, K, Wy)) * sc * 0.2
                                  ).to(device),
                 torch.from_numpy(rng.integers(1, ny - Wy, (Bp, K)).astype(
                     np.int32)).to(device),
                 torch.from_numpy(rng.random((Bp, K)) > 0.3).to(device),
                 table[:Bp].contiguous(), p0[:Bp].contiguous(),
                 ny_t[:Bp].contiguous())
        curve = _fused.prefix_devs_cuda(*pargs, L=L, measure="mae")
        eps = torch.sort(curve, dim=-1).values[:, K // 2].contiguous()
        kwp = dict(L=L, measure="mae", greedy=True)
        got = _fused.prefix_devs_cuda(*pargs, eps, **kwp)
        want, plain_ms = timed_once(lambda: _fused.prefix_devs_plain(
            *pargs, eps, **kwp), device)
        err = check_close(f"{name} prefix_devs B={Bp} (greedy, mae)",
                          "prefix_devs", got, want)
        require_lanes(f"{name} prefix_devs B={Bp} (greedy, mae)", got,
                      lambda b: _fused.prefix_devs_cuda(
                          *(a[b] for a in pargs[:6]), ny_t[b:b + 1],
                          eps[b:b + 1], **kwp))
        n_ok = int(pargs[3].sum())
        out.append(_lanes_entry(
            "prefix_devs", f"B={Bp} lanes x random: K={K} ok={n_ok} (all "
                           f"lanes) Wy={Wy} L={L} nyb={nyb} float64 greedy",
            err, device_ms(lambda: _fused.prefix_devs_cuda(
                *pargs, eps, **kwp), device, reps=5, inner=5),
            plain_ms, prefix_bound(Bp * K, n_ok, Wy, L, Bp * nyb), Bp))
    for r in out:
        r["dataset"] = name
    return out


# ---------------------------------------------------------------------------
# phase 4: the main path at full width
# ---------------------------------------------------------------------------

def remeasure(x: np.ndarray, xr: np.ndarray, cfg) -> float:
    """Exact D(S(xr), S(x)) from scratch, float64 on the CPU."""
    transform = _ops._transform_fn(cfg.stat)
    mfn = cameo._measure_fn(cfg)
    stats = []
    for series in (x, xr):
        y = aggregate_series(torch.from_numpy(series), cfg.kappa)
        agg = extract_aggregates(y, cfg.lags, backend="reference")
        stats.append(transform(acf_from_aggregates(agg, y.shape[0])))
    return float(mfn(stats[1], stats[0]))


def check_guarantee(what: str, x: np.ndarray, xr: np.ndarray,
                    kept: np.ndarray, dev: float, cfg) -> float:
    """The guarantee of one compressed series: deviation <= eps, a
    from-scratch float64 re-measure on the CPU agreeing to 1e-9, endpoints
    kept and kept values bit-exact.  Returns the re-measure."""
    require(dev <= cfg.eps + 1e-12, f"{what}: deviation {dev} > eps")
    re = remeasure(x, xr, cfg)
    require(abs(re - dev) <= 1e-9,
            f"{what}: re-measured deviation {re} != reported {dev}")
    require(bool(kept[0] and kept[-1]), f"{what}: an endpoint was dropped")
    require(np.array_equal(xr[kept], x[kept]),
            f"{what}: kept values are not bit-exact")
    return re


def _path_cfg(name: str, path: str):
    over, kernels, held = PATHS[path]
    return cameo.CameoConfig(eps=EPS, **dataset_cameo_kwargs(name),
                             **over), kernels, held


def first_differing_pop(device, cfg, x: np.ndarray) -> dict:
    """Step the sequential loop on the card and on the CPU side by side
    from their own inits and report the first pop whose kept masks differ:
    the point each removed and their popped impacts."""
    out = None
    states = []
    for dev in (torch.device(device), torch.device("cpu")):
        xt = torch.from_numpy(x).to(dev)
        carry, p0 = cameo._sequential_init(xt, cfg)
        states.append([carry, *cameo._sequential_fns(cfg, x.shape[0], p0)])
    pop = 0
    while bool(states[1][1](states[1][0])):
        pops = []
        for st in states:
            carry, _, body = st
            i = int(torch.argmin(carry[4]))
            pops.append(dict(point=i, impact=float(carry[4][i])))
            st[0] = body(carry)
        if not torch.equal(states[0][0][1].cpu(), states[1][0][1]):
            out = dict(pop=pop, card=pops[0], cpu=pops[1])
            break
        pop += 1
    return out or dict(pop=None, pops=pop)


def phase_main(device, name: str, path: str = "rounds", length=None,
               cpu_check: bool = True):
    cfg, kernels, held = _path_cfg(name, path)
    x = make_dataset(name, seed=0, length=length)
    n = (x.shape[0] // cfg.kappa) * cfg.kappa
    x = x[:n]
    if device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    res = cameo.compress(x, cfg, device=device)
    if device.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    mem = torch.cuda.max_memory_allocated() if device.type == "cuda" else None

    kept = res.kept.cpu().numpy()
    xr = res.xr.cpu().numpy()
    dev = float(res.deviation)
    what = f"{name} {path}"
    re = check_guarantee(what, x, xr, kept, dev, cfg)
    if device.type == "cuda":
        for kname in kernels:
            require(counts[kname] > 0,
                    f"{what}: kernel {kname} was never launched")
    cr = n / float(kept.sum())
    row = dict(dataset=name, path=path, n=n, lags=cfg.lags, kappa=cfg.kappa,
               iters=int(res.iters), cr=cr, deviation=dev, remeasured=re,
               wall_s=wall, s_per_iter=wall / max(int(res.iters), 1),
               launches=counts, max_memory_allocated=mem)
    if cpu_check and device.type == "cuda":
        t0 = time.perf_counter()
        ref = cameo.compress(x, cfg, device="cpu")
        row.update(cr_cpu=n / float(ref.n_kept), iters_cpu=int(ref.iters),
                   wall_s_cpu=time.perf_counter() - t0,
                   same_kept=bool(torch.equal(res.kept.cpu(), ref.kept)))
        if held:
            require(abs(cr - row["cr_cpu"]) <= 0.05 * row["cr_cpu"],
                    f"{what}: CR {cr} is not within 5% of the CPU path's "
                    f"{row['cr_cpu']}")
        if path == "sequential" and not row["same_kept"]:
            row["first_differing_pop"] = first_differing_pop(device, cfg, x)
    return row


# ---------------------------------------------------------------------------
# phase 4, batch: compress_batch and compress_multivariate
# ---------------------------------------------------------------------------

def batch_series(name: str, B: int, length=None) -> np.ndarray:
    """B series of dataset ``name`` (seeds 0..B-1) at full width, ``[B,
    n]``, trimmed to a multiple of kappa."""
    kap = dataset_cameo_kwargs(name).get("kappa", 1)
    xs = np.stack([make_dataset(name, seed=b, length=length)
                   for b in range(B)])
    return xs[:, :(xs.shape[1] // kap) * kap]


def _run_timed(fn, device):
    """(fn(), wall s, peak device memory) on a quiet card."""
    if device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = fn()
    if device.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    mem = torch.cuda.max_memory_allocated() if device.type == "cuda" else None
    return out, wall, mem


def phase_batch(device, name: str, B: int, held: bool, length=None) -> dict:
    """``compress_batch`` of B series of ``name`` on ``device``: every lane
    passes the guarantee checks, the round launches each kernel of the
    rounds path at most once a lane group (two groups), and, where
    ``held``, each lane equals its per-series ``compress_rounds`` run on the
    same device (kept mask, iterations and the deviation's bits)."""
    cfg = cameo.CameoConfig(eps=EPS, **dataset_cameo_kwargs(name))
    xs = batch_series(name, B, length)
    n = xs.shape[1]
    reset_counts()
    res, wall, mem = _run_timed(
        lambda: cameo.compress_batch(xs, cfg, device=device), device)
    counts = read_counts()
    kept, xr = res.kept.cpu().numpy(), res.xr.cpu().numpy()
    devs, iters = res.deviation.cpu().numpy(), res.iters.cpu().numpy()
    what = f"{name} batch B={B}"
    for b in range(B):
        check_guarantee(f"{what} lane {b}", xs[b], xr[b], kept[b],
                        float(devs[b]), cfg)
    rounds = int(iters.max())
    per_round = {k: c / max(rounds, 1) for k, c in counts.items()}
    if device.type == "cuda":
        for kname in PATHS["rounds"][1]:
            require(counts[kname] > 0,
                    f"{what}: kernel {kname} was never launched")
        require(per_round["acf_impact"] <= 2
                and per_round["window_rows"] <= 2 * TIERS,
                f"{what}: {per_round['acf_impact']} acf_impact and "
                f"{per_round['window_rows']} window_rows launches a round, "
                f"more than the two lane groups' 2 and {2 * TIERS}")
    row = dict(dataset=name, B=B, n=n, lags=cfg.lags, kappa=cfg.kappa,
               rounds=rounds, iters_min=int(iters.min()),
               cr_mean=float(np.mean(n / kept.sum(axis=1))),
               max_deviation=float(devs.max()), wall_s=wall,
               launches=counts, launches_per_round=per_round,
               max_memory_allocated=mem)
    if held:
        loop_s, dev_equal = 0.0, 0
        for b in range(B):
            one, s_b, _ = _run_timed(
                lambda: cameo.compress_rounds(xs[b], cfg, device=device),
                device)
            loop_s += s_b
            require(np.array_equal(one.kept.cpu().numpy(), kept[b])
                    and int(one.iters) == int(iters[b])
                    and float(one.deviation) == float(devs[b]),
                    f"{what}: lane {b} parts from its per-series run "
                    f"({int(iters[b])} rounds against {int(one.iters)}, "
                    f"deviation {float(devs[b])!r} against "
                    f"{float(one.deviation)!r})")
        row.update(loop_wall_s=loop_s, lanes_held=B)
    return row


def phase_multivariate(device, name: str = "uk_elec", C: int = MV_COLUMNS,
                       length=None) -> dict:
    """``compress_multivariate`` of ``X [n, C]`` (C series of ``name`` as
    columns): every column passes the guarantee checks on the shared
    index."""
    cfg = cameo.CameoConfig(eps=EPS, **dataset_cameo_kwargs(name))
    X = np.ascontiguousarray(batch_series(name, C, length).T)
    reset_counts()
    res, wall, mem = _run_timed(
        lambda: cameo.compress_multivariate(X, cfg, device=device), device)
    counts = read_counts()
    for c in range(C):
        check_guarantee(f"{name} multivariate column {c}", X[:, c],
                        res.xr[:, c], res.kept, float(res.deviations[c]),
                        cfg)
    if device.type == "cuda":
        for kname in PATHS["rounds"][1]:
            require(counts[kname] > 0, f"{name} multivariate: kernel "
                                       f"{kname} was never launched")
    return dict(dataset=name, C=C, n=X.shape[0], iters=res.iters,
                n_kept=res.n_kept, cr=X.shape[0] / res.n_kept,
                col_n_kept=res.col_n_kept.tolist(),
                deviations=res.deviations.tolist(), wall_s=wall,
                launches=counts, max_memory_allocated=mem)


def _scan_state(device, name: str, rounds: int, length=None):
    """A scan run on ``device`` stepped ``rounds`` rounds (one lane): the
    config, the round functions' arguments, p0, the carry and the next
    round's ``small``."""
    cfg, _, _ = _path_cfg(name, "scan")
    x = make_dataset(name, seed=0, length=length)
    n = (x.shape[0] // cfg.kappa) * cfg.kappa
    nb = cameo._round_bucket(n, cfg)
    xp = F.pad(torch.from_numpy(x[:n]), (0, nb - n)).to(device)[None]
    nv = torch.full((1,), n, dtype=torch.int32, device=device)
    min_alive, eps = cameo._halting_params(n, cfg)
    consts = (torch.full((1,), min_alive, dtype=torch.int32, device=device),
              torch.full((1,), eps, dtype=cfg.tdtype(), device=device))
    carry, p0 = cameo._rounds_init(xp, nv, cfg)
    probe, body = cameo._round_fns(cfg, nb, nv, *consts, p0)
    for _ in range(rounds):
        ((go, small),) = probe(carry).tolist()
        require(go, f"{name} scan ended before the lock-step round")
        carry = body(carry, small=small)
    ((go, small),) = probe(carry).tolist()
    require(go, f"{name} scan ended before the lock-step round")
    return cfg, (nb, nv, *consts, p0), carry, small


@contextlib.contextmanager
def card_dispatch(device):
    """On the CPU, dispatch the scan as on the card (its greedy branch, with
    every kernel wrapper taking its plain version for CPU tensors), so the
    card's path is rehearsed; nothing changes on the card."""
    if device.type == "cuda":
        yield
        return
    saved = _ops._kernel_eligible
    _ops._kernel_eligible = lambda backend, stat, measure, device=None: (
        stat == "acf" and measure in _ref.KERNEL_MEASURES)
    try:
        yield
    finally:
        _ops._kernel_eligible = saved


def capture_round(device, name: str, rounds: int = 3, length=None) -> dict:
    """The arguments of the prefix walk of the scan's lock-step round
    (round ``rounds``, after that many rounds on ``device``), captured
    through the round body's ``prefix_devs_fn`` hook: ``args`` is (y, dyws,
    ystarts, ok, table, p0, ny, eps) of the run's one lane."""
    device = torch.device(device)
    got = {}

    def recording(*a, **kw):
        got.setdefault("args", tuple(t[0].clone() for t in a))
        return _fused.prefix_devs_cuda(*a, **kw)
    with card_dispatch(device):
        cfg, fargs, carry, small = _scan_state(device, name, rounds, length)
        _, body = cameo._round_fns(cfg, *fargs, prefix_devs_fn=recording)
        body(carry, small=small)
    require("args" in got, f"{name} scan round {rounds} walked no prefix")
    return dict(round=rounds, args=got["args"])


def scan_lockstep(device, name: str = "uk_elec", rounds: int = 3) -> dict:
    """One scan round from one carry on the card, twice: the greedy branch
    with the prefix_devs kernel and with its plain version.  Their take
    masks (ok & devs <= eps) must be identical, and so the carries."""
    device = torch.device(device)
    cfg, fargs, carry, small = _scan_state(device, name, rounds)
    takes, outs = {}, {}
    for key, fn in (("kernel", _fused.prefix_devs_cuda),
                    ("plain", _fused.prefix_devs_plain)):
        def recording(*a, _fn=fn, _key=key, **kw):
            devs = _fn(*a, **kw)
            takes[_key] = (a[3] & (devs <= a[7][:, None])).cpu()
            return devs
        _, body_k = cameo._round_fns(cfg, *fargs, prefix_devs_fn=recording)
        outs[key] = body_k(carry, small=small)
    require(torch.equal(takes["kernel"], takes["plain"]),
            f"{name} lock-step scan round: the kernel's take mask differs "
            f"from the plain version's in "
            f"{int(torch.sum(takes['kernel'] != takes['plain']))} ranks")
    same = all(torch.equal(a, b) for a, b in zip(outs["kernel"],
                                                  outs["plain"]))
    require(same, f"{name} lock-step scan round: the carries differ")
    return dict(dataset=name, round=rounds, ranks=int(takes["kernel"].numel()),
                taken=int(takes["kernel"].sum()), takes_equal=True,
                carries_equal=same)


def run_phases(device, *, uk_length=None, aus_length=None,
               seq_lengths=None, seq_full=(), cpu_check: bool = True,
               batches=BATCHES, kernel_lanes=None,
               prefix_lanes: int = PREFIX_LANES, mv_columns: int = MV_COLUMNS,
               log=print) -> dict:
    """Phases 3-4 on ``device``: each kernel against its plain version at
    both datasets' shapes, one series and lanes (``kernel_lanes``, default
    ``KERNEL_LANES``), then the main paths on uk_elec and aus_elec (rounds
    and scan at ``uk_length``/``aus_length``, default full; sequential at
    ``seq_lengths``, default ``SEQ_LENGTHS``, and at full length for the
    datasets in ``seq_full``, without the CPU run), then the batch phase
    (``batches`` and ``compress_multivariate`` of ``mv_columns`` columns,
    at the same lengths).  Returns the report."""
    device = torch.device(device)
    lengths = dict(zip(DATASETS, (uk_length, aus_length)))
    seq_lengths = seq_lengths or SEQ_LENGTHS
    kernel_lanes = kernel_lanes or KERNEL_LANES
    seconds = {}
    t0 = time.perf_counter()
    kernels = []
    for name in DATASETS:
        kernels += phase_kernels(device, name, lengths[name])
    seconds["kernels"] = time.perf_counter() - t0
    for name in DATASETS:
        kernels += phase_kernels_lanes(
            device, name, kernel_lanes[name], lengths[name],
            prefix_lanes=prefix_lanes if name == "uk_elec" else 0)
    seconds["kernels_lanes"] = time.perf_counter() - t0 - seconds["kernels"]
    for k in kernels:
        log(f"kernel {k['name']} {k['dataset']} [{k['shape']}] max_abs_err="
            f"{k['max_abs_err']:.3e} tol rtol {TOL[k['name']][0]} + "
            f"{TOL[k['name']][1]} x max|plain| ms={k['ms']} "
            f"plain_ms={k['plain_ms']} library_ms={k['library_ms']} "
            f"bound_ms={k['bound_ms']:.3e} ({k['bound_by']})")
    floor = launch_floor_ms(device)
    log(f"launch_floor ms={floor} (an empty kernel, built and bound as the "
        f"port's kernels are)")
    runs = []
    totals = dict.fromkeys(WRAPPERS, 0)
    t0 = time.perf_counter()
    for path in PATHS:
        for name in DATASETS:
            length = seq_lengths[name] if path == "sequential" \
                else lengths[name]
            row = phase_main(device, name, path, length,
                             cpu_check=cpu_check)
            for kname, c in row["launches"].items():
                totals[kname] += c
            runs.append(row)
            log("main " + json.dumps(row))
    for name in seq_full:
        row = phase_main(device, name, "sequential", cpu_check=False)
        for kname, c in row["launches"].items():
            totals[kname] += c
        runs.append(row)
        log("main " + json.dumps(row))
    by = {(r["dataset"], r["path"]): r for r in runs}
    for name in DATASETS:
        # the scan's CR beside the card's backoff CR
        by[(name, "scan")]["cr_backoff"] = by[(name, "rounds")]["cr"]
    seconds["main_paths"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    batch_rows = []
    for name, B, held in batches:
        row = phase_batch(device, name, B, held, lengths[name])
        row["path"] = "batch"
        batch_rows.append(row)
        log("batch " + json.dumps(row))
    if mv_columns:
        row = phase_multivariate(device, "uk_elec", mv_columns,
                                 lengths["uk_elec"])
        row["path"] = "multivariate"
        batch_rows.append(row)
        log("multivariate " + json.dumps(row))
    for row in batch_rows:
        for kname, c in row["launches"].items():
            totals[kname] += c
    seconds["batch"] = time.perf_counter() - t0
    return dict(kernels=kernels, runs=runs, batches=batch_rows,
                launches=totals, launch_floor_ms=floor, seconds=seconds)


def kernel_rows(report) -> list:
    """The ``{"kernels": [...]}`` rows: one per kernel, timed at the first
    dataset's shapes, with every dataset's check and times under
    ``shapes``; ``max_abs_err`` is the largest over all of them."""
    rows = []
    for name in WRAPPERS:
        ks = [k for k in report["kernels"] if k["name"] == name]
        first = ks[0]
        rows.append(dict(
            name=name, route="cuda", source=SOURCES[name],
            replaces=REPLACES[name], launches=report["launches"][name],
            max_abs_err=max(k["max_abs_err"] for k in ks), ms=first["ms"],
            plain_ms=first["plain_ms"], bound_ms=first["bound_ms"],
            bound_by=first["bound_by"], library_ms=first["library_ms"],
            shapes=[{key: k[key] for key in (
                "dataset", "shape", "max_abs_err", "ms", "plain_ms",
                "bound_ms", "bound_by", "library_ms")} for k in ks]))
    return rows


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    require(out.returncode == 0, f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    print(nvidia_smi())
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; "
          f"allow_tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32}")

    info = _build.build_all()
    print(f"build: {info['seconds']:.1f} s")
    for stem, log in sorted(info["logs"].items()):
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {stem}: {line.strip()}")

    # uk_elec's sequential run at its full 17,520 points too: ~4 ms of
    # host dispatch a pop on the card, so its CPU twin (~10 ms a pop) is
    # left to the 4,096-point run
    seconds = {"build": info["seconds"]}
    t0 = time.perf_counter()
    report = run_phases(device, seq_full=("uk_elec",))
    seconds.update(report["seconds"])
    for r in report["runs"]:
        print("path " + json.dumps({k: r.get(k) for k in (
            "dataset", "path", "n", "iters", "iters_cpu", "cr", "cr_cpu",
            "cr_backoff", "same_kept", "wall_s", "s_per_iter",
            "wall_s_cpu")}))
    for r in report["batches"]:
        keys = (("dataset", "B", "n", "rounds", "iters_min", "cr_mean",
                 "wall_s", "loop_wall_s", "lanes_held",
                 "deviations_bit_equal", "launches_per_round",
                 "max_memory_allocated") if r["path"] == "batch" else
                ("dataset", "C", "n", "iters", "cr", "col_n_kept",
                 "deviations", "wall_s", "max_memory_allocated"))
        print(r["path"] + " " + json.dumps({k: r.get(k) for k in keys}))
    t0 = time.perf_counter()
    print("lockstep " + json.dumps(scan_lockstep(device)))
    seconds["lockstep"] = time.perf_counter() - t0
    print("seconds " + json.dumps(seconds))

    print(json.dumps({"kernels": kernel_rows(report)}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
