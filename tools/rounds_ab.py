#!/usr/bin/env python3
"""Whole-run walls of this tree's rounds-mode compressor against another
tree's, on one card, both in one process.

    python3 tools/rounds_ab.py --parent DIR [--reps 2]

DIR holds a checkout of the other commit (for example the parent:
``git archive <commit> | tar -x -C DIR``).  Both trees' packages are
loaded into this process (each under the name ``repro_torch``, swapped in
``sys.modules`` before each of its runs, its kernels built into its own
``build/``), so the two share the host, the process and its state.  Cases:
``compress()`` of ``chip_smoke.py``'s rounds and scan paths on uk_elec and
aus_elec (seed 0, full length, eps = 1e-2), and, where the tree has it,
``compress_batch`` of uk_elec at B = 16 and aus_elec at B = 4 (seeds
0..B-1).  Each case runs once a tree to warm, then ``--reps`` times in the
turns parent, this tree, this tree, parent, each run on the host clock
ending in ``torch.cuda.synchronize()``; its iterations (the slowest lane's
for a batch) and mean CR are printed beside the walls.

Then it profiles one uk_elec rounds run and one scan run of each tree
(``torch.profiler``): the wall, the card's busy time, the aten calls and
their own host time a round, and the ops whose count a round differs most
between the trees.

Prints one JSON line per tree and case (and per tree and profiled run) and
writes them all to ``chiprun_out/rounds_ab.json``.  Exits non-zero without
a card.
"""
from __future__ import annotations

import argparse
import importlib
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
EPS = 1e-2
# (dataset, path, lanes): lanes 0 is one series through compress()
CASES = (("uk_elec", "rounds", 0), ("uk_elec", "scan", 0),
         ("aus_elec", "rounds", 0), ("aus_elec", "scan", 0),
         ("uk_elec", "rounds", 16), ("aus_elec", "rounds", 4))
TURNS = ("parent", "this", "this", "parent")


class Tree:
    """One checkout's ``repro_torch`` modules, loaded side by side with
    another's."""

    def __init__(self, root: Path):
        for k in [k for k in sys.modules if k.split(".")[0] == "repro_torch"]:
            del sys.modules[k]
        sys.path.insert(0, str(root / "src"))
        try:
            self.cameo = importlib.import_module("repro_torch.core.cameo")
            importlib.import_module("repro_torch.kernels.ops")
        finally:
            sys.path.remove(str(root / "src"))
        self.modules = {k: v for k, v in sys.modules.items()
                        if k.split(".")[0] == "repro_torch"}

    def activate(self):
        """Route imports made inside the package's functions to this
        tree."""
        sys.modules.update(self.modules)
        return self.cameo


def case_runner(cameo, name: str, path: str, lanes: int):
    from repro_torch_data import dataset_cameo_kwargs, make_dataset
    import numpy as np
    kw = dataset_cameo_kwargs(name)
    cfg = cameo.CameoConfig(eps=EPS, **kw,
                            **({"select": "scan"} if path == "scan" else {}))
    kap = kw.get("kappa", 1)
    xs = np.stack([make_dataset(name, seed=b) for b in range(max(lanes, 1))])
    xs = xs[:, :(xs.shape[1] // kap) * kap]
    if lanes:
        return lambda: cameo.compress_batch(xs, cfg), xs.shape[1]
    return lambda: cameo.compress(xs[0], cfg), xs.shape[1]


def timed(run, n: int) -> dict:
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return dict(wall=wall, iters=int(res.iters.max()),
                cr=float(torch.mean(n / res.n_kept.double())))


def op_profile(tree: Tree, path: str) -> dict:
    """aten calls and their own host µs a round, and the card's busy µs a
    round, of one uk_elec run on ``path``."""
    from torch.profiler import ProfilerActivity, profile
    run, n = case_runner(tree.activate(), "uk_elec", path, 0)
    run()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        res = timed(run, n)
    events = prof.key_averages()
    ops = {e.key: (e.count, e.self_cpu_time_total) for e in events
           if e.key.startswith("aten::")}
    busy = sum(e.self_device_time_total for e in events
               if e.device_type.name == "CUDA")
    return dict(rounds=res["iters"], wall_s=res["wall"], ops=ops,
                busy_us=busy)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, required=True)
    ap.add_argument("--reps", type=int, default=2)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("rounds_ab: needs a CUDA card", file=sys.stderr)
        return 2
    import chip_smoke
    print(chip_smoke.nvidia_smi())
    # the datasets come from this tree, under a name of their own
    sys.path.insert(0, str(ROOT / "src"))
    sys.modules["repro_torch_data"] = importlib.import_module(
        "repro_torch.data.synthetic")
    sys.path.remove(str(ROOT / "src"))
    trees = {"parent": Tree(args.parent.resolve()), "this": Tree(ROOT)}
    rows = []
    for name, path, lanes in CASES:
        runs = {}
        for which, tree in trees.items():
            cameo = tree.activate()
            if lanes and not hasattr(cameo, "MVCompressResult"):
                continue            # a tree from before compress_batch
            runs[which] = case_runner(cameo, name, path, lanes)
            runs[which][0]()        # warm: builds and caches
        done = {w: [] for w in runs}
        for _ in range(args.reps):
            for which in TURNS:
                if which in runs:
                    trees[which].activate()
                    done[which].append(timed(*runs[which]))
        for which, rs in done.items():
            walls = [r["wall"] for r in rs]
            row = dict(dataset=name, path=path, lanes=lanes, tree=which,
                       iters=rs[-1]["iters"], cr=rs[-1]["cr"],
                       walls_s=walls, wall_s=statistics.mean(walls))
            rows.append(row)
            print("ab " + json.dumps(row), flush=True)
    for path in ("rounds", "scan"):
        prof = {w: op_profile(t, path) for w, t in trees.items()}
        per = {w: p["rounds"] for w, p in prof.items()}
        keys = set(prof["parent"]["ops"]) | set(prof["this"]["ops"])

        def at(w, k):
            c, us = prof[w]["ops"].get(k, (0, 0.0))
            return c / per[w], us / per[w]
        by_calls = sorted(keys, key=lambda k: -abs(at("this", k)[0]
                                                   - at("parent", k)[0]))
        for w in prof:
            calls = sum(c for c, _ in prof[w]["ops"].values()) / per[w]
            us = sum(t for _, t in prof[w]["ops"].values()) / per[w]
            row = dict(ops=w, path=path, rounds=per[w],
                       wall_s=prof[w]["wall_s"],
                       wall_us_per_round=1e6 * prof[w]["wall_s"] / per[w],
                       busy_us_per_round=prof[w]["busy_us"] / per[w],
                       aten_calls_per_round=calls,
                       aten_self_us_per_round=us,
                       calls_differing=[[k, *at(w, k)]
                                        for k in by_calls[:20]])
            rows.append(row)
            print("ops " + json.dumps(row), flush=True)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "rounds_ab.json").write_text(json.dumps(rows, indent=1))
    return 0


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    sys.exit(main())
