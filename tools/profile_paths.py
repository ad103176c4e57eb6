#!/usr/bin/env python3
"""Profile the port's main paths on one card and find where aus_elec's card
run parts from its CPU run.

    python3 tools/profile_paths.py

1. torch.profiler breakdowns of the uk_elec rounds run, both scan runs, the
   uk_elec batch at B = ``PROFILE_LANES`` and 256 pops of the uk_elec
   sequential run at 4,096 points: each hand kernel's device time and
   launches a round or a pop, the launches a round or a pop, the card's
   idle share and, for the scans, the ranks and ok ranks the prefix walks
   take a round.  One ``profile {...}`` line each, and the profiler's table
   in ``chiprun_out/profile_<dataset>_<path>.txt``.
2. The round where aus_elec's card run parts from its CPU run, with what
   differs there (``first_divergence``): one ``diverge {...}`` line and
   ``chiprun_out/diverge_aus_elec.json``.

Prints the card's name and power limit first and the seconds of each part
last; exits non-zero without a card.  It imports nothing of JAX or of the
JAX package; ``chip_smoke.py`` supplies the paths' configurations.
"""
from __future__ import annotations

import json
import sys
import time
from pathlib import Path

import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

from chip_smoke import (EPS, SEQ_LENGTHS, WRAPPERS, _path_cfg,  # noqa: E402
                        batch_series, nvidia_smi, require)
from repro_torch.core import cameo  # noqa: E402
from repro_torch.core.aggregates import interpolate_at  # noqa: E402
from repro_torch.data.synthetic import (dataset_cameo_kwargs,  # noqa: E402
                                        make_dataset)
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import acf_impact as _acf_impact  # noqa: E402
from repro_torch.kernels import fused_round as _fused  # noqa: E402
from repro_torch.kernels import ops as _ops  # noqa: E402
from repro_torch.kernels import ref as _ref  # noqa: E402

# lanes of the profiled compress_batch run (uk_elec)
PROFILE_LANES = 16
# rounds the divergence pass steps past the round where the free runs part
DIVERGE_PAST = 10


def _profiled_sequential(device, name: str, length: int, pops: int):
    """A sequential run of ``name`` at ``length`` points stepped past its
    first block of pops, then ``pops`` more under torch.profiler, in blocks
    of 128 with the host's one condition read after each, as
    compress_sequential drives them.  Returns (profiler, wall s, pops)."""
    from torch.profiler import ProfilerActivity, profile
    cfg, _, _ = _path_cfg(name, "sequential")
    x = torch.from_numpy(make_dataset(name, seed=0, length=length)).to(device)
    carry, p0 = cameo._sequential_init(x, cfg)
    probe, body = cameo._sequential_fns(cfg, x.shape[0], p0)
    block = cameo._SEQ_BLOCK
    for _ in range(block):
        carry = body(carry)
    it0 = int(carry[8])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(pops // block):
            for _ in range(block):
                carry = body(carry)
            require(bool(probe(carry)),
                    f"{name} sequential ended inside the profiled pops")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return prof, wall, int(carry[8]) - it0


def device_times(prof) -> tuple:
    """A profile's ``key_averages()``, their device-time sort key, and the
    card's µs and launches by kernel name."""
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
    return events, sort_key, dev_us, dev_n


def profile_main(device, name: str = "uk_elec", path: str = "rounds",
                 length=None, pops: int = 256) -> dict:
    """torch.profiler breakdown of one main-path run (rounds and scan: a
    whole run; sequential: ``pops`` pops of a run at ``length`` points;
    batch: ``compress_batch`` of ``PROFILE_LANES`` series): the card's
    busy time by kernel, each hand kernel's device time and launches an
    iteration (a round, of the slowest lane for a batch, or a pop), the
    idle share, and for the scan the ranks and ok ranks the prefix walks
    take a round; written under chiprun_out/."""
    from torch.profiler import ProfilerActivity, profile
    walks = []
    if path == "sequential":
        prof, wall, iters = _profiled_sequential(device, name, length, pops)
    elif path == "batch":
        cfg = cameo.CameoConfig(eps=EPS, **dataset_cameo_kwargs(name))
        xs = batch_series(name, PROFILE_LANES, length)
        cameo.compress_batch(xs, cfg, device=device)        # warm
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            res = cameo.compress_batch(xs, cfg, device=device)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        iters = int(res.iters.max())
    else:
        cfg, _, _ = _path_cfg(name, path)
        x = make_dataset(name, seed=0, length=length)
        # warm, counting the ranks and the ok ranks of every prefix walk
        # (the profiled run repeats the same rounds)
        kernel = _fused.prefix_devs_cuda

        def counting(*a, **kw):
            walks.append((a[3].numel(), a[3].sum()))
            return kernel(*a, **kw)
        # the wrapper counts its launches on the name it is bound to
        counting.launches = kernel.launches
        _fused.prefix_devs_cuda = counting
        try:
            cameo.compress(x, cfg, device=device)
        finally:
            _fused.prefix_devs_cuda = kernel
            kernel.launches = counting.launches
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            res = cameo.compress(x, cfg, device=device)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        iters = int(res.iters)
    events, sort_key, dev_us, dev_n = device_times(prof)
    busy = sum(dev_us.values()) / 1e6
    per = max(iters, 1)
    hand = {}
    for kname in WRAPPERS:
        # the kernels sit in anonymous namespaces: "(anonymous
        # namespace)::lag_dot_partials<double>(...)"
        keys = [k for k in dev_us if f"::{kname}_" in k]
        us = sum(dev_us[k] for k in keys)
        if keys:
            hand[kname] = dict(device_us=us,
                               launches=sum(dev_n[k] for k in keys),
                               device_us_per_iter=us / per,
                               share_of_wall=us / 1e6 / wall)
    hand_s = sum(h["device_us"] for h in hand.values()) / 1e6
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / f"profile_{name}_{path}.txt").write_text(
        events.table(sort_by=sort_key, row_limit=80))
    top = sorted(dev_us.items(), key=lambda kv: -kv[1])[:10]
    out = dict(dataset=name, path=path,
               lanes=PROFILE_LANES if path == "batch" else 1,
               iter="pop" if path == "sequential" else "round",
               iters=iters, wall_s=wall, host_s_per_iter=wall / per,
               device_busy_s=busy, idle_share=1.0 - busy / wall,
               device_launches=sum(dev_n.values()),
               launches_per_iter=sum(dev_n.values()) / per,
               hand_kernels_s=hand_s,
               hand_kernel_share_of_busy=hand_s / busy if busy else None,
               hand_kernels=hand,
               top_kernels_us={k[:60]: v for k, v in top})
    if path == "scan":
        out.update(prefix_walks=len(walks),
                   prefix_ranks_per_round=sum(k for k, _ in walks) / per,
                   prefix_ok_ranks_per_round=sum(int(o) for _, o in walks)
                   / per)
    return out


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
            dyw, ystart, _ = _ops.segment_cells(cfg, xr, prev, nxt, cand,
                                                WB if span <= WB else W)
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
    card computes from equal inputs.  The pass ends with the CPU run or
    ``DIVERGE_PAST`` rounds after the free runs part (``rounds_cpu`` counts
    the rounds stepped).  Reports the init's differences, the free runs'
    parting round and what differed in the state it started from, and the
    first ``keep`` lock-step rounds that differ."""
    device = torch.device(device)
    cpu = torch.device("cpu")
    cfg = cameo.CameoConfig(eps=EPS, **dataset_cameo_kwargs(name))
    x = make_dataset(name, seed=0, length=length)
    n = (x.shape[0] // cfg.kappa) * cfg.kappa
    nb = cameo._round_bucket(n, cfg)
    xp = F.pad(torch.from_numpy(x[:n]), (0, nb - n))
    min_alive, eps = cameo._halting_params(n, cfg)

    def setup(dev, p0=None):
        nv = torch.full((1,), n, dtype=torch.int32, device=dev)
        carry, p0_own = cameo._rounds_init(xp.to(dev)[None], nv, cfg)
        probe, body = cameo._round_fns(
            cfg, nb, nv, torch.full((1,), min_alive, dtype=torch.int32,
                                    device=dev),
            torch.full((1,), eps, dtype=cfg.tdtype(), device=dev),
            p0_own if p0 is None else p0.to(dev))
        return carry, p0_own, probe, body

    def lane0(carry):
        return tuple(t[0] for t in carry)

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
        ((go, small),) = probe_c(carry_c).tolist()
        state_l = tuple(t.to(device) for t in carry_c)
        (gl,) = probe_l(state_l).tolist()
        if gl != [go, small]:
            n_lock += 1
            if len(lockstep) < keep:
                lockstep.append(dict(round=r, probe_cpu=[go, small],
                                     probe_card=gl))
        if free_g:
            ((go_g, small_g),) = probe_g(carry_g).tolist()
        if not go or (parted is not None
                      and r >= parted["round"] + DIVERGE_PAST):
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
            kept_c, kept_g = nxt_c[1][0], nxt_g[1][0].cpu()
            if bool(torch.any(kept_c != kept_g)) or small_g != small:
                pts = torch.nonzero(kept_c != kept_g).view(-1)
                pts = pts[:8].tolist()
                parted = dict(round=r, small_cpu=small, small_card=small_g,
                              state_before=_carry_diffs(carry_c, carry_g),
                              after=_carry_diffs(nxt_c, nxt_g),
                              removed_cpu=[i for i in pts
                                           if not bool(kept_c[i])],
                              removed_card=[i for i in pts
                                            if not bool(kept_g[i])],
                              keys_cpu=_ranking_keys(lane0(carry_c), p0_c[0],
                                                     cfg, n, pts),
                              keys_card=_ranking_keys(lane0(carry_g),
                                                      p0_g[0], cfg, n, pts))
                free_g = False
            carry_g = nxt_g
        carry_c = nxt_c
        r += 1
    return dict(dataset=name, rounds_cpu=r, init=init, parted=parted,
                lockstep_rounds_differing=n_lock, lockstep_first=lockstep)


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_paths: no CUDA device; this tool runs on the card",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    print(nvidia_smi())
    _build.build_all()
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    seconds = {}
    t0 = time.perf_counter()
    # the rounds path, then the scan on both datasets: how much of a scan
    # round the prefix walk takes, from the trace
    for name, path in (("uk_elec", "rounds"), ("uk_elec", "scan"),
                       ("aus_elec", "scan"), ("uk_elec", "batch")):
        print("profile " + json.dumps(profile_main(device, name, path)),
              flush=True)
    # a block of sequential pops: the host dispatch a pop, and what the
    # ReHeap's acf_window_impact takes of it
    print("profile " + json.dumps(profile_main(
        device, "uk_elec", "sequential",
        length=SEQ_LENGTHS["uk_elec"], pops=256)), flush=True)
    seconds["profiles"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    div = first_divergence(device)
    (ROOT / "chiprun_out" / "diverge_aus_elec.json").write_text(
        json.dumps(div, indent=1))
    print("diverge " + json.dumps(div))
    seconds["divergence"] = time.perf_counter() - t0
    print("seconds " + json.dumps(seconds))
    return 0


if __name__ == "__main__":
    sys.exit(main())
