"""Dry-run of every (arch x shape) cell on the production mesh (port of
``repro.launch.dryrun``), traced on the meta device.

The reference lowers and compiles each cell's step under the production
mesh and rules on a forced host platform of 512 devices, and reads XLA's
memory and cost analyses and the partitioned HLO's collectives.  The port
runs no SPMD partitioner: its counterpart of "lower and compile" is to
run the cell's step at full width on ``torch.device("meta")`` (shapes and
dtypes, no data, no memory) under the production ``AbstractMesh`` and
rules (``sharding.use_sharding``): the train step's forward, backward and
optimizer update for train cells, ``prefill`` for prefill cells,
``decode_step`` against the cache stand-ins for decode cells.  That
proves the shapes compose for every cell.  The row keeps the reference's
schema: the analytic flops and HBM bytes a device (``launch.analytic``,
the reference's arithmetic), ``arg_bytes`` from the specs' shard shapes,
the model flops and their useful ratio, and the roofline terms against
the H100's datasheet figures (``HW``).  With no compiled collective
program, ``collective_s`` is null and ``dominant`` is the larger of
compute and memory; XLA's cost and memory analyses are null, each with
its reason.

Usage:
  python -m repro_torch.launch.dryrun --arch smollm-135m --shape train_4k
  python -m repro_torch.launch.dryrun --arch gemma3-27b --shape long_500k --multi-pod
  python -m repro_torch.launch.dryrun --all            # subprocess per cell
  (--set and --rule override config fields and rules; --tag names a
  variant)

A cell's trace costs host time a dispatched operation: the chunked
attention of a full-width ``prefill_32k`` cell is ~10^5-10^6 of them
(minutes), a decode cell about a second.  Results go to ``build/dryrun/``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import subprocess
import sys
import time

import torch

from repro_torch import sharding as shd
from repro_torch.configs.base import SHAPES
from repro_torch.configs.registry import (ARCH_IDS, LONG_CONTEXT_ARCHS,
                                          active_param_count, cells,
                                          get_config, get_reduced)
from repro_torch.launch.analytic import step_flops, step_hbm_bytes
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.specs import (batch_specs, default_train_config,
                                      opt_state_abstract, params_abstract)
from repro_torch.models.model import decode_step, prefill
from repro_torch.models.params import ParamTree
from repro_torch.train.step import build_train_step
from repro_torch.tree import leaves, tree_map

# NVIDIA H100 80GB HBM3 (SXM) at its 700.00 W limit, from the datasheet:
# dense bfloat16 and HBM3 bandwidth (per card)
HW = {"card": "NVIDIA H100 80GB HBM3, 700.00 W (datasheet)",
      "peak_flops": 989e12, "hbm_bw": 3.35e12}

RESULTS_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "..", "..", "..", "build", "dryrun")

NO_COLLECTIVES = ("the port runs no SPMD partitioner, so it has no compiled "
                  "collective program to read")
NO_XLA_COST = "no XLA compilation: the compute and memory terms are analytic"
NO_MEMORY = "no compiled program's memory analysis; the trace is on the " \
            "meta device"


def _arg_bytes(tree) -> int:
    """Per-device bytes of the stand-ins (their shard shapes)."""
    total = 0
    for leaf in leaves(tree):
        n = math.prod(leaf.shape)
        sh = leaf.sharding
        if sh is not None and sh.num_devices:
            try:
                n = math.prod(sh.shard_shape(leaf.shape))
            except ValueError:
                pass
        total += n * leaf.dtype.itemsize
    return total


def _parse_override(kv: str):
    k, v = kv.split("=", 1)
    for cast in (int, float):
        try:
            return k, cast(v)
        except ValueError:
            pass
    if v in ("True", "False"):
        return k, v == "True"
    if v == "None":
        return k, None
    return k, v


def _meta(tree):
    return tree_map(lambda s: s.meta(), tree)


def _shapes(tree) -> list:
    return [list(t.shape) for t in leaves(tree)]


def trace_cell(cfg, shape_name: str, params, opt=None, batch=None) -> dict:
    """Run the cell's step on the meta device from the stand-ins; returns
    the step's kind and its outputs' shapes."""
    kind = SHAPES[shape_name]["kind"]
    if kind == "train":
        tcfg = default_train_config(cfg)
        p = ParamTree(_meta(params)).requires_grad_(True)
        _, _, metrics = build_train_step(cfg, tcfg)(
            p, _meta(opt), _meta(batch), 0)
        return {"step": "train_step",
                "out_shapes": {k: list(v.shape) for k, v in metrics.items()
                               if isinstance(v, torch.Tensor)}}
    if kind == "prefill":
        logits, caches = prefill(ParamTree(_meta(params)), cfg,
                                 _meta(batch))
        return {"step": "prefill_step",
                "out_shapes": {"logits": list(logits.shape),
                               "caches": _shapes(caches)}}
    S = SHAPES[shape_name]["seq_len"]
    logits, _ = decode_step(ParamTree(_meta(params)), cfg,
                            batch["token"].meta(), _meta(batch["caches"]),
                            S - 1)
    return {"step": "serve_step", "out_shapes": {"logits": list(logits.shape)}}


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             extra_rules: dict | None = None, save: bool = True,
             overrides: dict | None = None, tag: str = "",
             reduced: bool = False) -> dict:
    """Trace one cell on the meta device (``reduced``: the reduced config
    at the cell's shape) and compute its roofline row (saved as
    ``<arch>_<shape>_<mesh>[__tag].json`` under ``RESULTS_DIR``)."""
    cfg = get_reduced(arch) if reduced else get_config(arch)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    info = SHAPES[shape_name]
    kind = info["kind"]
    chips = 512 if multi_pod else 256
    mesh = make_production_mesh(multi_pod=multi_pod)
    rules = shd.default_rules(multi_pod=multi_pod, fsdp=True)
    if shape_name == "long_500k":
        rules["act_cache_seq"] = "data"   # 512k caches sharded over data
    if extra_rules:
        rules.update(extra_rules)

    t0 = time.time()
    with shd.use_sharding(mesh, rules):
        params = params_abstract(cfg, mesh, rules)
        batch = batch_specs(cfg, shape_name, mesh, rules)
        opt = None
        if kind == "train":
            opt = opt_state_abstract(params, default_train_config(cfg), mesh)
            tokens = info["global_batch"] * info["seq_len"]
            model_flops = 6.0 * active_param_count(cfg) * tokens
        elif kind == "prefill":
            tokens = info["global_batch"] * info["seq_len"]
            model_flops = 2.0 * active_param_count(cfg) * tokens
        else:
            tokens = info["global_batch"]   # one token per sequence
            model_flops = 2.0 * active_param_count(cfg) * tokens
        traced = trace_cell(cfg, shape_name, params, opt, batch)
    t_trace = time.time() - t0

    model_par = shd.mesh_shape(mesh).get("model", 1)
    flops = step_flops(cfg, shape_name)["flops_global"] / chips
    bytes_acc = step_hbm_bytes(cfg, shape_name, chips,
                               model_par=model_par)["hbm_bytes_per_device"]
    terms = {"compute_s": flops / HW["peak_flops"],
             "memory_s": bytes_acc / HW["hbm_bw"]}
    dominant = max(terms, key=terms.get)
    step_time = max(terms.values())
    mf_per_device = model_flops / chips
    result = {
        "arch": arch, "shape": shape_name, "step": traced["step"],
        "mesh": "2x16x16" if multi_pod else "16x16", "chips": chips,
        "config": "reduced" if reduced else "full", "trace": "meta",
        "lower_s": round(t_trace, 2), "compile_s": None,
        "out_shapes": traced["out_shapes"],
        "per_device": {
            "hlo_flops": flops, "hlo_bytes": bytes_acc,
            "xla_cost_flops": None, "xla_cost_bytes": None,
            "xla_cost_reason": NO_XLA_COST,
            "collective_wire_bytes": None,
            "arg_bytes": _arg_bytes(params if kind != "train"
                                    else (params, opt)),
        },
        "collectives": {"by_kind": None, "op_counts": None,
                        "reason": NO_COLLECTIVES},
        "memory_analysis": None, "memory_analysis_reason": NO_MEMORY,
        "hw": HW,
        "roofline": {
            **terms, "collective_s": None,
            "collective_reason": NO_COLLECTIVES,
            "dominant": dominant,
            "model_flops_global": model_flops,
            "model_flops_per_device": mf_per_device,
            "useful_flops_ratio": mf_per_device / flops if flops > 0
            else None,
            "roofline_fraction": (mf_per_device / HW["peak_flops"])
            / step_time if step_time > 0 else None,
        },
    }
    if save:
        os.makedirs(RESULTS_DIR, exist_ok=True)
        fname = f"{arch}_{shape_name}_{result['mesh']}"
        if reduced:
            fname += "_reduced"
        if tag:
            fname += f"__{tag}"
            result["variant"] = tag
        result["path"] = os.path.abspath(os.path.join(RESULTS_DIR,
                                                      fname + ".json"))
        with open(result["path"], "w") as f:
            json.dump(result, f, indent=1)
    return result


def _print_result(r: dict):
    rf = r["roofline"]
    print(f"[dryrun] {r['arch']} x {r['shape']} on {r['mesh']} ({r['step']}, "
          f"{r['config']} config, traced on meta)")
    print(f"  trace {r['lower_s']}s; outputs {r['out_shapes']}")
    print(f"  per-device: {r['per_device']['hlo_flops']:.3e} flops, "
          f"{r['per_device']['hlo_bytes']:.3e} bytes, "
          f"{r['per_device']['arg_bytes']:.3e} argument bytes")
    print(f"  roofline: compute {rf['compute_s']:.4f}s | memory "
          f"{rf['memory_s']:.4f}s | collective not measured "
          f"-> dominant {rf['dominant']}")
    ratio, frac = rf["useful_flops_ratio"], rf["roofline_fraction"]
    print(f"  useful-flops ratio {ratio and round(ratio, 3)}; "
          f"roofline fraction {frac and round(frac, 4)}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=tuple(SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true",
                    help="run every runnable cell in subprocesses")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--timeout", type=int, default=3600)
    ap.add_argument("--set", action="append", default=[],
                    help="config override key=value (e.g. moe_impl=a2a)")
    ap.add_argument("--rule", action="append", default=[],
                    help="sharding-rule override key=value "
                         "(e.g. fsdp=None, act_seq=model)")
    ap.add_argument("--tag", default="",
                    help="variant tag for the result filename")
    args = ap.parse_args(argv)

    if args.all:
        meshes = [False, True] if args.both_meshes else [args.multi_pod]
        failures = []
        for arch, shape, _ in cells(include_skipped=False):
            for mp in meshes:
                cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                       "--arch", arch, "--shape", shape] + \
                    (["--multi-pod"] if mp else [])
                print(f"=== {arch} x {shape} ({'2x16x16' if mp else '16x16'})"
                      f" ===", flush=True)
                rc = subprocess.run(cmd, timeout=args.timeout).returncode
                if rc != 0:
                    failures.append((arch, shape, mp))
        if failures:
            print("FAILURES:", failures)
            sys.exit(1)
        print("ALL CELLS TRACED")
        return None

    if not args.arch or not args.shape:
        ap.error("--arch and --shape required (or --all)")
    if args.shape == "long_500k" and args.arch not in LONG_CONTEXT_ARCHS:
        print(f"[dryrun] SKIP {args.arch} x long_500k: pure full-attention "
              f"arch")
        return None
    overrides = dict(_parse_override(kv) for kv in args.set)
    extra_rules = dict(_parse_override(kv) for kv in args.rule) or None
    r = run_cell(args.arch, args.shape, args.multi_pod,
                 extra_rules=extra_rules, overrides=overrides, tag=args.tag)
    _print_result(r)
    return r


if __name__ == "__main__":
    main()
