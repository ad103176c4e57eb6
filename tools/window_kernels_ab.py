#!/usr/bin/env python3
"""The Eq. 9 window kernels of this tree against those of another tree,
on one card, in one process.

    python3 tools/window_kernels_ab.py --parent DIR [--variant NAME=DIR ...]
                                       [--no-real]

DIR holds a checkout of the other commit (for example the parent:
``git archive <commit> | tar -x -C DIR``).  Its
``src/repro_torch/kernels/csrc/acf_window_impact.cu`` and
``window_rows.cu`` are built with the same nvcc flags into
``build/ab_<name>/``; this tree's are built as the port builds them;
each ``--variant`` is one more tree, built the same way.

1. On each of ``chip_smoke.py``'s phase-3 cases of the two kernels (both
   datasets, the boundary-heavy cases too) every build is held against
   the plain version at tolerance 0 under mae, rmse and cheb, then timed
   under mae with CUDA events in turns (parent, this tree, the variants,
   then the same in reverse; each turn ``chip_smoke.device_ms``).
2. Real launches (unless ``--no-real``): ``chip_smoke.py``'s seven
   main-path runs on the card (rounds and scan on both datasets, the
   three sequential runs), every launch of the two kernels recorded with
   its arguments, its output and how many of its candidates are interior
   (``ref.interior_windows``: every head and tail mask 1).  Prints, per
   run and kernel, the launches, the share of launches with a candidate
   that is not interior and the interior share of candidates.  Then each
   build replays every recorded launch (its outputs must equal the
   recorded ones bit for bit) and is timed over them in the same turns:
   the launches with every candidate interior and the others apart, in
   chunks of 256 enqueued behind a busy card, so the sum is the kernel's
   launch-weighted device time over the real runs.

Prints one JSON line per case and writes all of them to
``chiprun_out/window_kernels_ab.json``.  Exits non-zero without a card or
on any disagreement.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import acf_window_impact as _awi  # noqa: E402
from repro_torch.kernels import fused_round as _fused  # noqa: E402
from repro_torch.kernels import ops as _ops  # noqa: E402
from repro_torch.kernels import ref as _ref  # noqa: E402

STEMS = ("acf_window_impact", "window_rows")


def build_other(name: str, tree: Path) -> dict:
    """Another tree's two window kernels, built and loaded."""
    out_dir = ROOT / "build" / f"ab_{name}"
    out_dir.mkdir(parents=True, exist_ok=True)
    csrc = tree / "src" / "repro_torch" / "kernels" / "csrc"
    procs = {}
    for stem in STEMS:
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
        libs[stem] = ctypes.CDLL(str(out))
    return libs


def cases(device):
    """(kernel, dataset, label, run(measure), plain(measure)) for every
    phase-3 case of the two kernels."""
    for name in chip_smoke.DATASETS:
        for c in chip_smoke.window_rows_cases(device, name):
            def run(measure, c=c):
                return _fused.window_rows_cuda(*c["args"], L=c["L"],
                                               measure=measure)

            def plain(measure, c=c):
                return _fused.window_rows_plain(*c["args"], L=c["L"],
                                                measure=measure)
            yield ("window_rows", name,
                   f"{c['label']}: K={c['K']} Wy={c['Wy']} L={c['L']} "
                   f"interior={c['interior']}", run, plain)
        for c in chip_smoke.window_impact_cases(device, name):
            def run(measure, c=c):
                return _awi.acf_window_impact_cuda(
                    *c["args"], ny=c["ny"], L=c["L"], measure=measure)

            def plain(measure, c=c):
                return _awi.acf_window_impact_plain(
                    *c["args"], ny=c["ny"], L=c["L"], measure=measure)
            yield ("acf_window_impact", name,
                   f"{c['label']}: P={c['P']} W={c['W']} L={c['L']} "
                   f"interior={c['interior']}", run, plain)


# the main-path runs of chip_smoke.py: (dataset, path, length)
RUNS = [(name, path, chip_smoke.SEQ_LENGTHS[name] if path == "sequential"
         else None) for path in chip_smoke.PATHS
        for name in chip_smoke.DATASETS] + [("uk_elec", "sequential", None)]
# the kernel's wrapper as its caller looks it up: (module, name)
CALLERS = {"acf_window_impact": (_ops, "acf_window_impact_cuda"),
           "window_rows": (_fused, "window_rows_cuda")}


def record_runs(device) -> list:
    """The seven main-path runs on the card, each launch of the two
    kernels recorded: (run, kernel, launches) with each launch a dict of
    its arguments, keywords, output and interior count."""
    out = []
    for name, path, length in RUNS:
        got = {k: [] for k in STEMS}
        saved = {}
        for kname, (mod, attr) in CALLERS.items():
            wrapper = getattr(mod, attr)
            saved[kname] = wrapper

            def recording(*a, _w=wrapper, _k=kname, **kw):
                res = _w(*a, **kw)
                # the count lands on the original or on this recorder
                me = getattr(CALLERS[_k][0], CALLERS[_k][1])
                _w.launches = me.launches = max(_w.launches, me.launches)
                if _k == "acf_window_impact":
                    starts, W, ny = a[2], a[1].shape[1], kw["ny"]
                else:
                    starts, W, ny = a[2], a[1].shape[1], a[4]
                inter = _ref.interior_windows(starts, W, kw["L"], ny).sum()
                got[_k].append(dict(args=tuple(t.clone() for t in a), kw=kw,
                                    out=res.clone(), interior=inter,
                                    n=starts.numel()))
                return res
            # a wrapper counts its launches on the name it is bound to
            recording.launches = wrapper.launches
            setattr(mod, attr, recording)
        try:
            row = chip_smoke.phase_main(device, name, path, length,
                                        cpu_check=False)
        finally:
            for kname, (mod, attr) in CALLERS.items():
                setattr(mod, attr, saved[kname])
        for kname, calls in got.items():
            if not calls:
                continue
            inter = torch.stack([c["interior"] for c in calls]).tolist()
            for c, i in zip(calls, inter):
                c["interior"] = int(i)
            out.append((dict(dataset=name, path=path, n=row["n"],
                             iters=row["iters"], cr=row["cr"]), kname, calls))
    return out


def replay_ms(kname: str, calls: list, device, chunk: int = 256) -> float:
    """Device ms of ``calls`` launched back to back through the kernel's
    wrapper, in chunks enqueued while the card is held busy."""
    wrapper = getattr(*CALLERS[kname])
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


def real_rows(device, libs, use, turns) -> list:
    """Interior shares and replay times of every build over the recorded
    launches of the seven main-path runs."""
    rows = []
    use("this")
    for run, kname, calls in record_runs(device):
        wrapper = getattr(*CALLERS[kname])
        split = {"all_interior": [c for c in calls if c["interior"] == c["n"]],
                 "with_boundary": [c for c in calls
                                   if c["interior"] < c["n"]]}
        row = dict(run, kernel=kname, launches=len(calls),
                   launches_with_boundary=len(split["with_boundary"]),
                   share_launches_with_boundary=len(split["with_boundary"])
                   / len(calls),
                   candidates=sum(c["n"] for c in calls),
                   interior_candidates=sum(c["interior"] for c in calls))
        row["interior_share"] = row["interior_candidates"] / row["candidates"]
        for which in libs:
            use(which)
            for c in calls:
                chip_smoke.require(
                    torch.equal(wrapper(*c["args"], **c["kw"]), c["out"]),
                    f"{which} {kname} differs from the recorded output on "
                    f"a real launch of {run['dataset']} {run['path']}")
        for part, sub in split.items():
            if not sub:
                continue
            times = {which: [] for which in libs}
            for which in turns:
                use(which)
                times[which].append(replay_ms(kname, sub, device))
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
    ap.add_argument("--no-real", action="store_true",
                    help="time the phase-3 cases only")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("window_kernels_ab: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    print(chip_smoke.nvidia_smi())
    _build.build_all()
    libs = {"parent": build_other("parent", args.parent.resolve()),
            "this": {s: _build.library(s) for s in STEMS}}
    for v in args.variant:
        name, tree = v.split("=", 1)
        libs[name] = build_other(name, Path(tree).resolve())
    turns = list(libs) + list(libs)[::-1]

    def use(which):
        for stem in STEMS:
            _build.use_library(stem, libs[which][stem])

    rows = []
    for kname, dataset, label, run, plain in cases(device):
        row = dict(kernel=kname, dataset=dataset, case=label)
        for which in libs:
            use(which)
            err = 0.0
            for measure in chip_smoke.MEASURES:
                err = max(err, chip_smoke.check_close(
                    f"{which} {kname} {dataset} {label} ({measure})", kname,
                    run(measure), plain(measure)))
            row[f"max_abs_err_{which}"] = err
        times = {which: [] for which in libs}
        for which in turns:
            use(which)
            times[which].append(chip_smoke.device_ms(
                lambda: run("mae"), device))
        for which, ts in times.items():
            row[f"ms_{which}"] = statistics.mean(ts)
            row[f"ms_{which}_turns"] = ts
        row["ratio"] = row["ms_this"] / row["ms_parent"]
        rows.append(row)
        print("ab " + json.dumps(row), flush=True)
    use("this")
    floor = chip_smoke.launch_floor_ms(device)
    print("launch_floor " + json.dumps({"ms": floor}))
    real = [] if args.no_real else real_rows(device, libs, use, turns)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "window_kernels_ab.json").write_text(json.dumps(
        dict(card=chip_smoke.nvidia_smi(), launch_floor_ms=floor, rows=rows,
             real=real), indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
