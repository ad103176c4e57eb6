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
   the main path's shapes of both datasets (uk_elec: n = 18,432, L = 48;
   aus_elec: nb = 245,760 onto nyb = 5,120, kappa = 48, L = 7), every
   measure, with the tolerance stated, timed with CUDA events (kernel,
   plain version and, for lag_dot, a PyTorch conv1d yardstick);
4. main path — ``compress()`` at full width on uk_elec (n = 17,520,
   L = 48) and aus_elec (n = 230,688, L = 7, kappa = 48) on the card:
   deviation <= eps, a from-scratch float64 re-measure on the CPU agrees,
   endpoints kept, kept values bit-exact, every kernel launched, and point
   CR within 5% of the same call on the CPU;
5. diagnostics — a torch.profiler breakdown of one uk_elec run
   (``chiprun_out/profile_uk_elec.txt``), and the round where aus_elec's
   card run parts from its CPU run with what differs there
   (``chiprun_out/diverge_aus_elec.json``); then a ``{"kernels": [...]}``
   line;
6. the last line, ``{"ok": true, "device": {...}}``.

It imports nothing of JAX or of the JAX package.  ``run_phases`` is the
same sequence for any device and size; the CPU tests rehearse it on tiny
inputs, where the wrappers take their plain versions.
"""
from __future__ import annotations

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
from repro_torch.core.aggregates import (interpolate_at,  # noqa: E402
                                         segment_deltas)
from repro_torch.data.synthetic import (dataset_cameo_kwargs,  # noqa: E402
                                        make_dataset)
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import acf_impact as _acf_impact  # noqa: E402
from repro_torch.kernels import fused_round as _fused  # noqa: E402
from repro_torch.kernels import lag_dot as _lag_dot  # noqa: E402
from repro_torch.kernels import ops as _ops  # noqa: E402
from repro_torch.kernels import ref as _ref  # noqa: E402

# H100 SXM published peaks (NVIDIA data sheet, dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
FP64_FLOPS = 34e12          # FP64 outside the tensor cores
FP32_FLOPS = 67e12          # FP32 outside the tensor cores

WRAPPERS = {"lag_dot": _lag_dot.lag_dot_cuda,
            "acf_impact": _acf_impact.acf_impact_cuda,
            "window_rows": _fused.window_rows_cuda}
SOURCES = {"lag_dot": "src/repro_torch/kernels/csrc/lag_dot.cu",
           "acf_impact": "src/repro_torch/kernels/csrc/acf_impact.cu",
           "window_rows": "src/repro_torch/kernels/csrc/window_rows.cu"}
REPLACES = {"lag_dot": "src/repro/kernels/lag_dot.py:42",
            "acf_impact": "src/repro/kernels/acf_impact.py:93",
            "window_rows": "src/repro/kernels/fused_round.py:276"}
# Each output is held to its plain version elementwise: |got - want| <=
# rtol |want| + floor max|want|.  The floor scales with the output, so an
# output of the wrong scale (zeros, say) fails whatever the inputs' size.
TOL = {"lag_dot": (1e-10, 1e-10), "acf_impact": (1e-4, 1e-6),
       "window_rows": (1e-4, 1e-6)}
DATASETS = ("uk_elec", "aus_elec")
EPS = 1e-2


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


def phase_kernels(device, name: str, length=None) -> list:
    """Each kernel against its plain version at ``name``'s main-path
    shapes; one entry per kernel (window_rows: its two tier launches of
    one full-size round together)."""
    cfg, n, nb, ny, y64, table, p0, dval = kernel_inputs(device, name,
                                                         length)
    L, kap, nyb = cfg.lags, cfg.kappa, y64.shape[0]
    rng = np.random.default_rng(1)
    ny_t = torch.full((), ny, dtype=torch.int32, device=device)
    y32, t32, p32, d32 = y64.float(), table.float(), p0.float(), dval.float()
    out = []

    # lag_dot: Eq. 7 sxx at init, float64 (the self form reads y once)
    got = _lag_dot.lag_dot_cuda(y64, L=L)
    want = _lag_dot.lag_dot_plain(y64, L=L)
    err = check_close(f"{name} lag_dot", "lag_dot", got, want)
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

    # acf_impact: Eq. 8 impacts of every point, float32, runtime ny and the
    # i // kappa map; every measure is held, mae (the default) is timed
    err = 0.0
    for measure in ("mae", "rmse", "cheb"):
        kw = dict(L=L, measure=measure, ny=ny_t, kappa=kap)
        got = _acf_impact.acf_impact_cuda(y32, d32, t32, p32, **kw)
        want = _acf_impact.acf_impact_plain(y32, d32, t32, p32, **kw)
        err = max(err, check_close(f"{name} acf_impact ({measure})",
                                   "acf_impact", got, want))
    kw = dict(L=L, measure="mae", ny=ny_t, kappa=kap)
    # per (point, lag): 7 for the five moment updates, 12 for Eq. 2 with its
    # sqrt and divide, 3 for the measure; per point 3 for e = d (2 y + d)
    bnd, by = bound_ms((nyb + nb + 6 * L + nb) * 4, nb * (22.0 * L + 3),
                       FP32_FLOPS)
    out.append(dict(
        name="acf_impact", shape=f"P={nb} nyb={nyb} kappa={kap} L={L} "
                                 f"float32",
        max_abs_err=err,
        ms=device_ms(lambda: _acf_impact.acf_impact_cuda(
            y32, d32, t32, p32, **kw), device),
        plain_ms=device_ms(lambda: _acf_impact.acf_impact_plain(
            y32, d32, t32, p32, **kw), device),
        library_ms=None, bound_ms=bnd, bound_by=by))

    # window_rows: Eq. 9 tier impacts at the full-size round's capacities,
    # tier B (spans 2..8) and tier C (9..64) mapped onto y
    W, WB = cfg.window, cameo._TIER_SMALL_W
    tiers = []
    scale = float(torch.std(d32)) * kap
    for K, Wx in ((min(nb, max(24, nb // 24)), WB),
                  (min(nb, max(16, nb // 48)), W)):
        Wy = Wx if kap == 1 else Wx // kap + 2
        starts = torch.from_numpy(
            rng.integers(1, ny - Wy, K).astype(np.int32)).to(device)
        dyws = torch.from_numpy(
            (rng.standard_normal((K, Wy)) * scale).astype(np.float32)
        ).to(device)
        args = (y32, dyws, starts, t32, ny_t, p32)
        e = 0.0
        for measure in ("mae", "rmse", "cheb"):
            got = _fused.window_rows_cuda(*args, L=L, measure=measure)
            want = _fused.window_rows_plain(*args, L=L, measure=measure)
            e = max(e, check_close(
                f"{name} window_rows (K={K}, Wy={Wy}, {measure})",
                "window_rows", got, want))
        # per (candidate, lag): 4 Wy for the bilinear sum, 2 for the tail
        # sums, 5 to add the table, 12 for Eq. 2, 3 for the measure; per
        # candidate 3 Wy for e and 2 Wy for the prefix sums of d and e
        bnd, by = bound_ms(
            (K * Wy + K + min(nyb, K * (Wy + 2 * L)) + 6 * L + K) * 4,
            K * (L * (4.0 * Wy + 22) + 5.0 * Wy), FP32_FLOPS)
        tiers.append(dict(
            name="window_rows", shape=f"K={K} Wy={Wy} L={L} float32",
            max_abs_err=e,
            ms=device_ms(lambda: _fused.window_rows_cuda(
                *args, L=L, measure="mae"), device),
            plain_ms=device_ms(lambda: _fused.window_rows_plain(
                *args, L=L, measure="mae"), device),
            library_ms=None, bound_ms=bnd, bound_by=by))
    row = dict(tiers[0])
    row["shape"] = " + ".join(t["shape"] for t in tiers)
    row["max_abs_err"] = max(t["max_abs_err"] for t in tiers)
    for key in ("ms", "plain_ms", "bound_ms"):
        vals = [t[key] for t in tiers]
        row[key] = None if None in vals else sum(vals)
    row["bound_by"] = max(tiers, key=lambda t: t["bound_ms"])["bound_by"]
    out.append(row)
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


def phase_main(device, name: str, length=None, cpu_check: bool = True):
    spec = dataset_cameo_kwargs(name)
    cfg = cameo.CameoConfig(eps=EPS, **spec)
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
    require(dev <= cfg.eps + 1e-12, f"{name}: deviation {dev} > eps")
    re = remeasure(x, xr, cfg)
    require(abs(re - dev) <= 1e-9,
            f"{name}: re-measured deviation {re} != reported {dev}")
    require(bool(kept[0] and kept[-1]), f"{name}: an endpoint was dropped")
    require(np.array_equal(xr[kept], x[kept]),
            f"{name}: kept values are not bit-exact")
    if device.type == "cuda":
        for kname, c in counts.items():
            require(c > 0, f"{name}: kernel {kname} was never launched")
    cr = n / float(kept.sum())
    row = dict(dataset=name, n=n, lags=cfg.lags, kappa=cfg.kappa,
               rounds=int(res.iters), cr=cr, deviation=dev, remeasured=re,
               wall_s=wall, launches=counts, max_memory_allocated=mem)
    if cpu_check and device.type == "cuda":
        ref = cameo.compress(x, cfg, device="cpu")
        cr_cpu = n / float(ref.n_kept)
        require(abs(cr - cr_cpu) <= 0.05 * cr_cpu,
                f"{name}: CR {cr} is not within 5% of the CPU path's "
                f"{cr_cpu}")
        row.update(cr_cpu=cr_cpu, rounds_cpu=int(ref.iters))
    return row


def profile_main(device, name: str = "uk_elec") -> dict:
    """torch.profiler breakdown of one main-path run (the card's busy time
    by kernel) written under chiprun_out/."""
    from torch.profiler import ProfilerActivity, profile
    spec = dataset_cameo_kwargs(name)
    cfg = cameo.CameoConfig(eps=EPS, **spec)
    x = make_dataset(name, seed=0)
    cameo.compress(x, cfg, device=device)            # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = cameo.compress(x, cfg, device=device)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    sort_key = ("self_device_time_total"
                if hasattr(events[0], "self_device_time_total")
                else "self_cuda_time_total")
    dev_us, dev_n = {}, {}
    for ev in events:
        t = float(getattr(ev, sort_key, 0.0) or 0.0)
        if t and ev.device_type == torch.autograd.DeviceType.CUDA:
            dev_us[ev.key] = dev_us.get(ev.key, 0.0) + t
            dev_n[ev.key] = dev_n.get(ev.key, 0) + int(ev.count)
    ours = {k: v for k, v in dev_us.items()
            if any(s in k for s in ("lag_dot", "acf_impact", "window_rows"))}
    busy = sum(dev_us.values()) / 1e6
    rounds = int(res.iters)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / f"profile_{name}.txt").write_text(
        events.table(sort_by=sort_key, row_limit=80))
    top = sorted(dev_us.items(), key=lambda kv: -kv[1])[:10]
    return dict(dataset=name, rounds=rounds, wall_s=wall,
                host_s_per_round=wall / max(rounds, 1),
                device_busy_s=busy, idle_share=1.0 - busy / wall,
                device_launches=sum(dev_n.values()),
                launches_per_round=sum(dev_n.values()) / max(rounds, 1),
                hand_kernels_s=sum(ours.values()) / 1e6,
                hand_kernel_share_of_busy=sum(ours.values()) / 1e6 / busy
                if busy else None,
                top_kernels_us={k[:60]: v for k, v in top})


_CARRY_FIELDS = ("xr", "alive", "prev", "nxt", "y", "tbl", "alpha", "dev",
                 "rounds", "done", "blocked", "retried", "saw_c")


def _carry_diffs(a, b) -> dict:
    """Fields of two rounds carries that differ: the count of differing
    elements and, for float fields, the largest difference."""
    out = {}
    for name, u, v in zip(_CARRY_FIELDS, a, b):
        u, v = u.cpu(), v.cpu()
        ne = u != v
        if bool(torch.any(ne)):
            d = dict(n_differ=int(torch.sum(ne)))
            if u.is_floating_point():
                d["max_abs_diff"] = float(torch.max(torch.abs(u - v)))
            out[name] = d
    return out


def _ranking_keys(carry, p0, cfg, n: int, points) -> dict:
    """The float32 ranking keys of ``points`` in the round that starts from
    ``carry``, formed as the rounds body forms them: Eq. 8 for span 1,
    Eq. 9 for spans 2..W (a tier's capacity cut and the blocks are not
    applied, and are reported beside the key)."""
    xr, alive, prev, nxt, y, tbl = carry[:6]
    blocked = carry[10]
    dev = xr.device
    L, kap, W, WB = cfg.lags, cfg.kappa, cfg.window, cameo._TIER_SMALL_W
    ny = torch.full((), n // kap, dtype=torch.int32, device=dev)
    yr, tr, pr = y.float(), tbl.float(), p0.to(dev).float()
    idx = torch.arange(xr.shape[0], dtype=torch.int32, device=dev)
    dx = interpolate_at(xr, prev, nxt, idx) - xr
    dval = (dx if kap == 1 else _ref.div_exact(dx, kap)).float()
    single = _acf_impact.acf_impact_cuda(yr, dval, tr, pr, L=L,
                                         measure=cfg.measure, ny=ny,
                                         kappa=kap)
    out = {}
    for i in points:
        span = int(nxt[i] - prev[i] - 1)
        key = float("inf")
        if span == 1:
            key = float(single[i])
        elif span <= W:
            cand = torch.tensor([i], dtype=torch.int32, device=dev)
            dwin, start, _ = segment_deltas(xr, prev, nxt, cand,
                                            WB if span <= WB else W)
            dyw, ystart = _ops.x_window_to_y(cfg, dwin, start)
            key = float(_fused.window_rows_cuda(
                yr, dyw.float().contiguous(), ystart.contiguous(), tr, ny,
                pr, L=L, measure=cfg.measure)[0])
        out[int(i)] = dict(span=span, alive=bool(alive[i]),
                           blocked=bool(blocked[i]), key=key)
    return out


def first_divergence(device, name: str = "aus_elec", length=None,
                     keep: int = 5) -> dict:
    """Where the card's run of ``name`` parts from the CPU path's.

    Two comparisons in one pass over the rounds: the two free runs, each
    from its own init, compared after every round until their kept masks
    first differ; and a lock-step run, where every round starts the card
    from the CPU path's carry (and p0), so a difference there is one the
    card computes from equal inputs.  Reports the init's differences, the
    free runs' parting round and what differed in the state it started
    from, and the first ``keep`` lock-step rounds that differ."""
    device = torch.device(device)
    cpu = torch.device("cpu")
    cfg = cameo.CameoConfig(eps=EPS, **dataset_cameo_kwargs(name))
    x = make_dataset(name, seed=0, length=length)
    n = (x.shape[0] // cfg.kappa) * cfg.kappa
    nb = cameo._round_bucket(n, cfg)
    xp = F.pad(torch.from_numpy(x[:n]), (0, nb - n))
    min_alive, eps = cameo._halting_params(n, cfg)

    def setup(dev, p0=None):
        nv = torch.full((), n, dtype=torch.int32, device=dev)
        carry, p0_own = cameo._rounds_init(xp.to(dev), nv, cfg)
        probe, body = cameo._round_fns(
            cfg, nb, nv, torch.full((), min_alive, dtype=torch.int32,
                                    device=dev),
            torch.full((), eps, dtype=cfg.tdtype(), device=dev),
            p0_own if p0 is None else p0.to(dev))
        return carry, p0_own, probe, body

    carry_c, p0_c, probe_c, body_c = setup(cpu)
    carry_g, p0_g, probe_g, body_g = setup(device)
    _, _, probe_l, body_l = setup(device, p0_c)
    init = _carry_diffs(carry_c, carry_g)
    if bool(torch.any(p0_c != p0_g.cpu())):
        init["p0"] = dict(max_abs_diff=float(torch.max(torch.abs(
            p0_c - p0_g.cpu()))))
    parted = None
    lockstep, n_lock = [], 0
    r = 0
    free_g = True
    while True:
        go, small = probe_c(carry_c).tolist()
        state_l = tuple(t.to(device) for t in carry_c)
        gl = probe_l(state_l).tolist()
        if gl != [go, small]:
            n_lock += 1
            if len(lockstep) < keep:
                lockstep.append(dict(round=r, probe_cpu=[go, small],
                                     probe_card=gl))
        if free_g:
            go_g, small_g = probe_g(carry_g).tolist()
        if not go:
            break
        nxt_c = body_c(carry_c, small=small)
        d = _carry_diffs(nxt_c, body_l(state_l, small=small))
        if d:
            n_lock += 1
            if len(lockstep) < keep:
                lockstep.append(dict(round=r, small=small, fields=d))
        if free_g and not go_g:
            parted = dict(round=r, card_run_ended=True,
                          state_before=_carry_diffs(carry_c, carry_g))
            free_g = False
        if free_g:
            nxt_g = body_g(carry_g, small=small_g)
            if bool(torch.any(nxt_c[1] != nxt_g[1].cpu())) or \
                    small_g != small:
                pts = torch.nonzero(nxt_c[1] != nxt_g[1].cpu()).view(-1)
                pts = pts[:8].tolist()
                parted = dict(round=r, small_cpu=small, small_card=small_g,
                              state_before=_carry_diffs(carry_c, carry_g),
                              after=_carry_diffs(nxt_c, nxt_g),
                              removed_cpu=[i for i in pts
                                           if not bool(nxt_c[1][i])],
                              removed_card=[i for i in pts
                                            if not bool(nxt_g[1][i])],
                              keys_cpu=_ranking_keys(carry_c, p0_c, cfg, n,
                                                     pts),
                              keys_card=_ranking_keys(carry_g, p0_g, cfg, n,
                                                      pts))
                free_g = False
            carry_g = nxt_g
        carry_c = nxt_c
        r += 1
    return dict(dataset=name, rounds_cpu=r, init=init, parted=parted,
                lockstep_rounds_differing=n_lock, lockstep_first=lockstep)


def run_phases(device, *, uk_length=None, aus_length=None,
               cpu_check: bool = True, log=print) -> dict:
    """Phases 3-4 on ``device``: each kernel against its plain version at
    both datasets' shapes, then the main path on uk_elec and aus_elec.
    Returns the report."""
    device = torch.device(device)
    lengths = dict(zip(DATASETS, (uk_length, aus_length)))
    kernels = []
    for name in DATASETS:
        for k in phase_kernels(device, name, lengths[name]):
            kernels.append(k)
            log(f"kernel {k['name']} {name} [{k['shape']}] max_abs_err="
                f"{k['max_abs_err']:.3e} tol rtol {TOL[k['name']][0]} + "
                f"{TOL[k['name']][1]} x max|plain| ms={k['ms']} "
                f"plain_ms={k['plain_ms']} library_ms={k['library_ms']} "
                f"bound_ms={k['bound_ms']:.3e} ({k['bound_by']})")
    runs = []
    totals = dict.fromkeys(WRAPPERS, 0)
    for name in DATASETS:
        row = phase_main(device, name, lengths[name], cpu_check=cpu_check)
        for kname, c in row["launches"].items():
            totals[kname] += c
        runs.append(row)
        log("main " + json.dumps(row))
    return dict(kernels=kernels, runs=runs, launches=totals)


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

    report = run_phases(device)
    print("profile " + json.dumps(profile_main(device)))
    div = first_divergence(device)
    (ROOT / "chiprun_out" / "diverge_aus_elec.json").write_text(
        json.dumps(div, indent=1))
    print("diverge " + json.dumps(div))

    print(json.dumps({"kernels": kernel_rows(report)}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
