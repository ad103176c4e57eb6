#!/usr/bin/env python3
"""Profile the port's train step: where a step's time goes.

    python3 tools/profile_training.py [--arch musicgen-large] [--layers N]
                                      [--device cuda|cpu] [--reduced]
                                      [--batch 8] [--seq 1024]
                                      [--form unbind|index]

``--arch`` (default musicgen-large) at its published width (or
``--reduced``), cut to ``--layers`` blocks if given, weights drawn from
seed 0 (on the card there, as chip_smoke's training phase draws them),
``build_train_step`` under ``default_train_config`` on ``token_batch``es
of ``--batch`` x ``--seq`` tokens: two warm steps, then one step under
torch.profiler.  One ``profile_training {...}`` line: the step's wall s,
the card's busy s and idle share, launches, the device time by kind of
kernel (matrix products, softmax, reductions, elementwise, copies, the
rest) and the kernels that take the most; the
profiler's table in ``chiprun_out/profile_training_<arch>.txt``.  Prints
the card's name and power limit first; ``--device cuda`` without a card
exits non-zero.  It imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import re
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "tools"))

from chip_smoke import _sync, nvidia_smi  # noqa: E402
from profile_paths import device_times  # noqa: E402
from repro_torch.configs.registry import get_config, get_reduced  # noqa: E402
from repro_torch.core.cameo import _device  # noqa: E402
from repro_torch.data.pipeline import token_batch  # noqa: E402
from repro_torch.launch.specs import default_train_config  # noqa: E402
from repro_torch.models.model import model_defs  # noqa: E402
from repro_torch.models.params import init_params  # noqa: E402
from repro_torch.train.step import (TrainConfig, build_train_step,  # noqa: E402
                                    init_opt_state)

# the kinds of kernel a step's device time is split into, first match wins
# (cuBLAS's Hopper kernels do not all name their type: the bfloat16
# projections and the float32 attention products are one kind here)
KINDS = (("gemm", r"gemm|xmma|cutlass|nvjet"),
         ("softmax", r"softmax"),
         ("reduce", r"reduce"),
         ("copy_cat", r"copy|cat|memcpy|memset|fill"),
         ("elementwise", r"elementwise"))


def kind_of(name: str) -> str:
    low = name.lower()
    for kind, pat in KINDS:
        if re.search(pat, low):
            return kind
    return "other"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="musicgen-large")
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=1024)
    ap.add_argument("--form", choices=("unbind", "index"), default="unbind")
    args = ap.parse_args(argv)
    device = _device(args.device)
    if device.type == "cuda":
        print(nvidia_smi())
        torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    if args.layers is not None:
        n = args.layers // len(cfg.pattern)
        cfg = dataclasses.replace(cfg, n_blocks=n, remainder=(),
                                  n_layers=n * len(cfg.pattern))
    tcfg = TrainConfig(optimizer=default_train_config(cfg).optimizer,
                       peak_lr=3e-4, warmup=2, total_steps=10)
    params = init_params(model_defs(cfg), 0, device, cfg.pdtype(),
                         draw="device" if device.type == "cuda" else "cpu")
    params.requires_grad_(True)
    opt = init_opt_state(params, tcfg)
    step = build_train_step(cfg, tcfg, unbind=args.form == "unbind")
    for i in range(2):                                   # warm
        params, opt, _ = step(params, opt, token_batch(
            cfg, args.batch, args.seq, i, device=device), i)
    batch = token_batch(cfg, args.batch, args.seq, 2, device=device)
    row = dict(arch=cfg.name, layers=cfg.n_layers, dtype=cfg.param_dtype,
               remat=cfg.remat, form=args.form, device=str(device),
               B=args.batch, S=args.seq)
    _sync(device)
    if device.type != "cuda":
        t0 = time.perf_counter()
        step(params, opt, batch, 2)
        row["cpu_wall_s"] = time.perf_counter() - t0
        print("profile_training " + json.dumps(row))
        return 0
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(params, opt, batch, 2)
        _sync(device)
        wall = time.perf_counter() - t0
    events, key, dev_us, dev_n = device_times(prof)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / f"profile_training_{args.arch}_{args.form}.txt").write_text(
        events.table(sort_by=key, row_limit=80))
    busy = sum(dev_us.values()) / 1e6
    kinds = {}
    for name, us in dev_us.items():
        k = kind_of(name)
        kinds[k] = kinds.get(k, 0.0) + us / 1e6
    top = sorted(dev_us.items(), key=lambda kv: -kv[1])[:10]
    row.update(wall_s=wall, device_busy_s=busy, idle_share=1.0 - busy / wall,
               launches=sum(dev_n.values()),
               device_s_by_kind=dict(sorted(kinds.items(),
                                            key=lambda kv: -kv[1])),
               top_kernels_s={k[:70]: v / 1e6 for k, v in top},
               max_memory_allocated=torch.cuda.max_memory_allocated())
    print("profile_training " + json.dumps(row))
    return 0


if __name__ == "__main__":
    sys.exit(main())
