#!/usr/bin/env python3
"""The port's kernels in this tree against those of another tree, on one
card, in one process.

    python3 tools/window_kernels_ab.py --parent DIR [--variant NAME=DIR ...]
                                       [--kernels NAME,...] [--no-real]

DIR holds a checkout of the other commit (for example the parent:
``git archive <commit> | tar -x -C DIR``).  Its
``src/repro_torch/kernels/csrc/`` sources of the kernels in ``STEMS`` are
built with the same nvcc flags into ``build/ab_<name>/``, and its kernel
wrappers (``kernels/*.py``) are loaded beside this tree's, so a kernel
whose C interface changed is still called as its own tree calls it; this
tree's kernels are built as the port builds them; each ``--variant`` is one
more tree, built the same way.  ``--kernels`` keeps a subset of STEMS.

1. On each of ``chip_smoke.py``'s phase-3 cases of the kernels (both
   datasets; the window kernels' boundary-heavy cases too; dense_sxx on
   one series, on ``KERNEL_LANES`` lanes and at min_temp's 365 lags;
   segment_scan in both modes at the searches' error bounds, as
   ``run_baselines`` holds it) every build is
   held against its own tree's plain version (the tree's ``kernels/ref.py``
   loaded with it, since trees may sum in other orders; lag_dot against
   this tree's) under mae, rmse and cheb (prefix_devs: its greedy walk
   under mae, and at K <= 4,096 under rmse and cheb too; prefix_sum's,
   dense_sxx's and segment_scan's plain versions on the CPU;
   segment_scan exactly), at ``chip_smoke.TOL``, then timed under
   mae with CUDA events in turns
   (parent, this tree, the variants, then the same in reverse; each turn
   ``chip_smoke.device_ms``).
2. Real launches (unless ``--no-real``): ``chip_smoke.py``'s seven
   main-path runs on the card (rounds and scan on both datasets, the
   three sequential runs), every launch of the kernels recorded with its
   arguments, its output and, for the two Eq. 9 window kernels, how many
   of its candidates are interior (``ref.interior_windows``: every head
   and tail mask 1).  Prints, per run and kernel, the launches and, for
   the window kernels, the share of launches with a candidate that is not
   interior and the interior share of candidates.  Then each build
   replays every recorded launch (its outputs must equal the recorded
   ones at ``chip_smoke.TOL``, dense_sxx's bit for bit, or for prefix_sum
   its own tree's plain version on the CPU bit for bit; segment_scan has
   no main-path launches) and is timed over them in the same turns
   (the window kernels' launches with every candidate interior and the
   others apart), in chunks of 256 enqueued behind a busy card, so the sum
   is the kernel's launch-weighted device time over the real runs.  The
   recorded outputs are this tree's, so trees whose ranking kernels reduce
   the lags in another order (a tree from before the row-reduce order, at
   L > 32) are compared with ``--no-real``.

Prints one JSON line per case and writes all of them to
``chiprun_out/window_kernels_ab.json``.  Exits non-zero without a card or
on any disagreement.
"""
from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import ref as _ref  # noqa: E402

STEMS = ("acf_window_impact", "window_rows", "acf_impact", "lag_dot",
         "prefix_devs", "prefix_sum", "dense_sxx", "segment_scan")
WINDOW = ("acf_window_impact", "window_rows")
# each kernel's wrapper: (module of kernels/, function)
WRAPPER_OF = {"acf_window_impact": ("acf_window_impact",
                                    "acf_window_impact_cuda"),
              "window_rows": ("fused_round", "window_rows_cuda"),
              "acf_impact": ("acf_impact", "acf_impact_cuda"),
              "lag_dot": ("lag_dot", "lag_dot_cuda"),
              "prefix_devs": ("fused_round", "prefix_devs_cuda"),
              "prefix_sum": ("prefix_sum", "prefix_sum_cuda"),
              "dense_sxx": ("dense_sxx", "dense_sxx_cuda"),
              "segment_scan": ("segment_scan", "segment_scan_cuda")}
# each kernel's plain version (name in the same module), held to its own
# tree's: the trees may sum in other orders
OWN_PLAIN = {"acf_window_impact": "acf_window_impact_plain",
             "window_rows": "window_rows_plain",
             "acf_impact": "acf_impact_plain",
             "prefix_devs": "prefix_devs_plain",
             "prefix_sum": "prefix_sum_plain",
             "dense_sxx": "dense_sxx_plain",
             "segment_scan": "segment_scan_plain"}


def tree_ref(name: str, tree: Path):
    """The tree's ``kernels/ref.py`` (the sums its plain versions take),
    loaded under a name of its own."""
    path = tree / "src" / "repro_torch" / "kernels" / "ref.py"
    spec = importlib.util.spec_from_file_location(f"ab_{name}_ref", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def build_other(name: str, tree: Path, stems) -> dict:
    """Another tree's kernels, built and loaded."""
    out_dir = ROOT / "build" / f"ab_{name}"
    out_dir.mkdir(parents=True, exist_ok=True)
    csrc = tree / "src" / "repro_torch" / "kernels" / "csrc"
    procs = {}
    for stem in stems:
        out = out_dir / f"lib{stem}.so"
        procs[stem] = (out, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out),
             str(csrc / f"{stem}.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    libs = {}
    for stem, (out, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"build of {name}'s {stem}.cu failed:\n{log}")
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas {name} {stem}: {line.strip()}")
        libs[stem] = ctypes.CDLL(str(out))
    return libs


def tree_wrappers(name: str, tree: Path, stems, plain: bool = False) -> dict:
    """kernel -> its wrapper as ``tree`` writes it (with ``plain``, its
    OWN_PLAIN version): the tree's module of ``kernels/`` loaded under a
    name of its own.  It imports this tree's ``_build``, whose libraries
    ``use`` swaps, and this tree's other modules, but for ``ref``, the
    tree's own."""
    mods, out = {}, {}
    ref = tree_ref(name, tree)
    if plain:
        stems = [k for k in stems if k in OWN_PLAIN]
    for kname in stems:
        mod, fn = WRAPPER_OF[kname]
        if mod not in mods:
            path = tree / "src" / "repro_torch" / "kernels" / f"{mod}.py"
            spec = importlib.util.spec_from_file_location(
                f"ab_{name}_{mod}", path)
            mods[mod] = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mods[mod])
            if hasattr(mods[mod], "_ref"):
                mods[mod]._ref = ref
        out[kname] = getattr(mods[mod], OWN_PLAIN[kname] if plain else fn)
    return out


def cases(device, stems):
    """(kernel, dataset, label, call(wrapper, measure), plain(measure),
    measures held) for every phase-3 case of the kernels."""
    every = chip_smoke.MEASURES
    for name in chip_smoke.DATASETS:
        if "window_rows" in stems:
            for c in chip_smoke.window_rows_cases(device, name):
                def run(w, measure, c=c):
                    return w(*c["args"], L=c["L"], measure=measure)

                def plain(measure, fn, c=c):
                    return fn(*c["args"], L=c["L"], measure=measure)
                yield ("window_rows", name,
                       f"{c['label']}: K={c['K']} Wy={c['Wy']} L={c['L']} "
                       f"interior={c['interior']}", run, plain, every)
        if "acf_window_impact" in stems:
            for c in chip_smoke.window_impact_cases(device, name):
                def run(w, measure, c=c):
                    return w(*c["args"], ny=c["ny"], L=c["L"],
                             measure=measure)

                def plain(measure, fn, c=c):
                    return fn(*c["args"], ny=c["ny"], L=c["L"],
                              measure=measure)
                yield ("acf_window_impact", name,
                       f"{c['label']}: P={c['P']} W={c['W']} L={c['L']} "
                       f"interior={c['interior']}", run, plain, every)
        if "acf_impact" in stems:
            for c in chip_smoke.acf_impact_cases(device, name):
                def run(w, measure, c=c):
                    return w(*c["args"], measure=measure, **c["kw"])

                def plain(measure, fn, c=c):
                    return fn(*c["args"], measure=measure, **c["kw"])
                yield "acf_impact", name, c["shape"], run, plain, every
        if "lag_dot" in stems:
            cfg, _, _, _, y64, *_ = chip_smoke.kernel_inputs(device, name)

            def run(w, measure, y64=y64, L=cfg.lags):
                return w(y64, L=L)

            def plain(measure, y64=y64, L=cfg.lags):
                return chip_smoke._lag_dot.lag_dot_plain(y64, L=L)
            yield ("lag_dot", name, f"n={y64.shape[0]} L={cfg.lags} float64",
                   run, plain, ("mae",))
        if "prefix_devs" in stems:
            for c in chip_smoke.prefix_cases(device, name):
                K, Wy = c["args"][1].shape

                def run(w, measure, c=c):
                    return w(*c["args"], c["eps"], L=c["args"][4].shape[1],
                             measure=measure, greedy=True)

                def plain(measure, fn, c=c):
                    return fn(*c["args"], c["eps"], L=c["args"][4].shape[1],
                              measure=measure, greedy=True)
                ok = int(c["args"][3].sum())
                # the plain walk takes ~15 s a measure at aus_elec's K
                yield ("prefix_devs", name,
                       f"{c['label']}: K={K} ok={ok} Wy={Wy} greedy", run,
                       plain, every if K <= 4096 else ("mae",))
        if "prefix_sum" in stems:
            y64 = chip_smoke.kernel_inputs(device, name)[4]
            rows = [y64, torch.stack([y64, y64 * y64])]
            if name == chip_smoke.DATASETS[0]:
                rng = np.random.default_rng(5)
                rows += [torch.from_numpy(rng.standard_normal((2, n))).to(
                    device) for n in chip_smoke.PREFIX_SUM_LENGTHS]
            for x in rows:
                def run(w, measure, x=x):
                    return w(x)

                def plain(measure, fn, x=x):
                    return fn(x.cpu()).to(device)
                yield ("prefix_sum", name, f"{list(x.shape)} float64", run,
                       plain, ("mae",))
        if "dense_sxx" in stems:
            # one series (a round's delta on the bucket), the lanes of
            # KERNEL_LANES, and (with uk_elec) min_temp's 365 lags
            cfg, _, _, ny, y64, *_ = chip_smoke.kernel_inputs(device, name)
            B = chip_smoke.KERNEL_LANES[name]
            _, _, _, yl, *_, nyt = chip_smoke.lanes_inputs(device, name, B)
            dl = torch.stack([chip_smoke.dense_delta(yl[b], ny, seed=b)
                              for b in range(B)])
            forms = [(name, y64, chip_smoke.dense_delta(y64, ny), ny,
                      cfg.lags), (name, yl, dl, nyt, cfg.lags)]
            if name == chip_smoke.DATASETS[0]:
                c365, _, _, n365, y365, *_ = chip_smoke.kernel_inputs(
                    device, "min_temp")
                forms.append(("min_temp", y365,
                              chip_smoke.dense_delta(y365, n365), n365,
                              c365.lags))
            for dname, y, d, ny_, L in forms:
                def run(w, measure, y=y, d=d, ny_=ny_, L=L):
                    return w(y, d, ny_, L)

                def plain(measure, fn, y=y, d=d, ny_=ny_, L=L):
                    return fn(y.cpu(), d.cpu(), ny_.cpu() if isinstance(
                        ny_, torch.Tensor) else ny_, L).to(device)
                yield ("dense_sxx", dname, f"{list(y.shape)} L={L} float64",
                       run, plain, ("mae",))
        if "segment_scan" in stems:
            # chip_smoke.run_baselines' holds: the search's parameter and
            # SEGMENT_SCAN_SPREAD times it, float64; float32 at the first
            x, params = segment_scan_params(device, name)
            xt = torch.from_numpy(x).to(device)
            for mode in chip_smoke._segscan.MODES:
                err = params[mode]
                for xs, e in ((xt, err),
                              (xt, chip_smoke.SEGMENT_SCAN_SPREAD * err),
                              (xt.float(), err)):
                    def run(w, measure, xs=xs, e=e, mode=mode):
                        return _flat(w(xs, e, mode))

                    def plain(measure, fn, xs=xs, e=e, mode=mode):
                        return _flat(fn(xs.cpu(), e, mode)).to(device)
                    yield ("segment_scan", name,
                           f"{mode} n={xs.shape[0]} {xs.dtype} err={e:.6g}",
                           run, plain, ("mae",))


def segment_scan_params(device, name: str) -> tuple:
    """``name``'s baseline series and the PMC and Swing searches'
    parameters on the card, the error bounds chip_smoke.py's segment_scan
    holds take (``run_baselines``)."""
    x, cfg = chip_smoke._baseline_series(name)
    params = {mode: chip_smoke._bl.acf_constrained_search(
        x, cfg, chip_smoke._search_fn(mode),
        iters=chip_smoke.BASELINE_ITERS, device=device)[3]
        for mode in chip_smoke._segscan.MODES}
    return x, params


def _flat(outs) -> torch.Tensor:
    """segment_scan's outputs as one float64 row (the flags as 0 / 1)."""
    return torch.cat([o.to(torch.float64) for o in outs])


# the main-path runs of chip_smoke.py: (dataset, path, length)
RUNS = [(name, path, chip_smoke.SEQ_LENGTHS[name] if path == "sequential"
         else None) for path in chip_smoke.PATHS
        for name in chip_smoke.DATASETS] + [("uk_elec", "sequential", None)]
def _one_series(kname: str, a: tuple, kw: dict, res):
    """A one-lane launch of the rounds path (``[1, ...]`` operands, as
    ``compress_rounds`` makes them) as the same launch on one series, so
    the wrappers of a tree from before the lane axis replay it too."""
    if kname == "acf_window_impact" or a[0].dim() != 2 or a[0].shape[0] != 1:
        return a, kw, res

    def one(t):
        return t[0] if isinstance(t, torch.Tensor) and t.dim() >= 2 else t
    return (tuple(one(t) for t in a), {k: one(v) for k, v in kw.items()},
            res[0])


def record_runs(device, stems) -> list:
    """The seven main-path runs on the card, each launch of the kernels
    recorded (``chip_smoke.record_launches``): (run, kernel, launches) with
    each launch a dict of its arguments, keywords, output and, for the
    window kernels, its interior count."""
    out = []
    for name, path, length in RUNS:
        with chip_smoke.record_launches(stems) as got:
            row = chip_smoke.phase_main(device, name, path, length,
                                        cpu_check=False)
        for kname, launches in got.items():
            if not launches:
                continue
            calls = []
            for a, kw, res in launches:
                a, kw, res = _one_series(kname, a, kw, res)
                rec = dict(args=a, kw=kw, out=res)
                if kname in WINDOW:
                    starts, W = a[2], a[1].shape[1]
                    ny = kw["ny"] if kname == "acf_window_impact" else a[4]
                    rec["interior"] = _ref.interior_windows(
                        starts, W, kw["L"], ny).sum()
                    rec["n"] = starts.numel()
                calls.append(rec)
            if kname in WINDOW:
                inter = torch.stack([c["interior"] for c in calls]).tolist()
                for c, i in zip(calls, inter):
                    c["interior"] = int(i)
            out.append((dict(dataset=name, path=path, n=row["n"],
                             iters=row["iters"], cr=row["cr"]), kname, calls))
    return out


def replay_ms(wrapper, calls: list, device, chunk: int = 256) -> float:
    """Device ms of ``calls`` launched back to back through ``wrapper``, in
    chunks enqueued while the card is held busy."""
    total = 0.0
    for c0 in range(0, len(calls), chunk):
        torch.cuda._sleep(50_000_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for c in calls[c0:c0 + chunk]:
            wrapper(*c["args"], **c["kw"])
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total


def real_rows(device, libs, wrappers, plains, use, turns, stems) -> list:
    """Replay times of every build over the recorded launches of the seven
    main-path runs, with the window kernels' interior shares."""
    rows = []
    use("this")
    for run, kname, calls in record_runs(device, stems):
        row = dict(run, kernel=kname, launches=len(calls))
        if kname in WINDOW:
            split = {"all_interior": [c for c in calls
                                      if c["interior"] == c["n"]],
                     "with_boundary": [c for c in calls
                                       if c["interior"] < c["n"]]}
            row.update(
                launches_with_boundary=len(split["with_boundary"]),
                share_launches_with_boundary=len(split["with_boundary"])
                / len(calls),
                candidates=sum(c["n"] for c in calls),
                interior_candidates=sum(c["interior"] for c in calls))
            row["interior_share"] = (row["interior_candidates"]
                                     / row["candidates"])
        else:
            split = {"all": calls}
        for which in libs:
            use(which)
            what = (f"{which} {kname}: a real launch of {run['dataset']} "
                    f"{run['path']} against its recorded output")
            for c in calls:
                got = wrappers[which][kname](*c["args"], **c["kw"])
                if kname == "prefix_sum":
                    # its own plain version's bits (a real launch's rows
                    # may be all zeros, which check_close refuses)
                    want = plains[which][kname](
                        *(a.cpu() for a in c["args"]), **c["kw"])
                    chip_smoke.require(torch.equal(got.cpu(), want), what)
                elif kname == "dense_sxx":
                    # the recorded bits (a round's delta may be all zeros)
                    chip_smoke.require(torch.equal(got, c["out"]), what)
                else:
                    chip_smoke.check_close(what, kname, got, c["out"])
        for part, sub in split.items():
            if not sub:
                continue
            times = {which: [] for which in libs}
            for which in turns:
                use(which)
                times[which].append(replay_ms(wrappers[which][kname], sub,
                                              device))
            for which, ts in times.items():
                row[f"{part}_ms_{which}"] = statistics.mean(ts)
                row[f"{part}_ms_{which}_turns"] = ts
                row[f"{part}_us_per_launch_{which}"] = \
                    1e3 * statistics.mean(ts) / len(sub)
        for which in libs:
            row[f"total_ms_{which}"] = sum(
                row.get(f"{part}_ms_{which}", 0.0) for part in split)
        row["ratio"] = row["total_ms_this"] / row["total_ms_parent"]
        rows.append(row)
        print("real " + json.dumps(row), flush=True)
        del calls, split
    use("this")
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True, type=Path,
                    help="a checkout of the other commit")
    ap.add_argument("--variant", action="append", default=[],
                    metavar="NAME=DIR", help="one more tree to time")
    ap.add_argument("--kernels", default=",".join(STEMS),
                    help="the kernels to compare (default all)")
    ap.add_argument("--no-real", action="store_true",
                    help="time the phase-3 cases only")
    args = ap.parse_args()
    stems = tuple(k for k in STEMS if k in args.kernels.split(","))
    if not torch.cuda.is_available():
        print("window_kernels_ab: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    print(chip_smoke.nvidia_smi())
    _build.build_all()
    trees = {"parent": args.parent.resolve()}
    for v in args.variant:
        name, tree = v.split("=", 1)
        trees[name] = Path(tree).resolve()
    libs = {"parent": build_other("parent", trees["parent"], stems),
            "this": {s: _build.library(s) for s in stems}}
    wrappers = {"parent": tree_wrappers("parent", trees["parent"], stems),
                "this": dict(chip_smoke.WRAPPERS)}
    plains = {"this": tree_wrappers("this", ROOT, stems, plain=True)}
    for name, tree in trees.items():
        if name != "parent":
            libs[name] = build_other(name, tree, stems)
            wrappers[name] = tree_wrappers(name, tree, stems)
        plains.setdefault(name, tree_wrappers(name, tree, stems, plain=True))
    turns = list(libs) + list(libs)[::-1]

    def use(which):
        for stem in stems:
            _build.use_library(stem, libs[which][stem])

    rows = []
    for kname, dataset, label, run, plain, measures in cases(device, stems):
        row = dict(kernel=kname, dataset=dataset, case=label)
        mine = kname not in OWN_PLAIN and {m: plain(m) for m in measures}
        for which in libs:
            use(which)
            want = mine or {m: plain(m, plains[which][kname])
                            for m in measures}
            err = 0.0
            for measure in measures:
                what = f"{which} {kname} {dataset} {label} ({measure})"
                got = run(wrappers[which][kname], measure)
                if kname == "segment_scan":
                    # its flags may all be 0: held exactly, not relatively
                    chip_smoke.require(torch.equal(got, want[measure]),
                                       f"{what} disagrees with its plain "
                                       f"version")
                    continue
                err = max(err, chip_smoke.check_close(what, kname, got,
                                                      want[measure]))
            row[f"max_abs_err_{which}"] = err
        times = {which: [] for which in libs}
        reps = (5, 5) if kname in ("prefix_devs", "segment_scan") \
            else (7, 20)
        for which in turns:
            use(which)
            w = wrappers[which][kname]
            times[which].append(chip_smoke.device_ms(
                lambda: run(w, "mae"), device, *reps))
        for which, ts in times.items():
            row[f"ms_{which}"] = statistics.mean(ts)
            row[f"ms_{which}_turns"] = ts
        row["ratio"] = row["ms_this"] / row["ms_parent"]
        rows.append(row)
        print("ab " + json.dumps(row), flush=True)
        use("this")   # the next case's inputs are made through this tree
    floor = chip_smoke.launch_floor_ms(device)
    print("launch_floor " + json.dumps({"ms": floor}))
    real = [] if args.no_real else real_rows(device, libs, wrappers, plains,
                                             use, turns, stems)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "window_kernels_ab.json").write_text(json.dumps(
        dict(card=chip_smoke.nvidia_smi(), launch_floor_ms=floor, rows=rows,
             real=real), indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
