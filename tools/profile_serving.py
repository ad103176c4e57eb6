#!/usr/bin/env python3
"""Profile the port's serving path: where a decode step's time goes.

    python3 tools/profile_serving.py [--arch qwen3-0.6b] [--layers N]
                                     [--device cuda|cpu] [--reduced]
                                     [--batch 8] [--prompt-len 2048]
                                     [--steps 8]

``--arch`` (default qwen3-0.6b) at its published width in bfloat16 (or
``--reduced``), cut to ``--layers`` blocks of its pattern if given,
weights from seed 0 (drawn on the card there: other values than the CPU's
draw, as chip_smoke's zoo phase draws them): a prefill of ``--batch``
prompts of ``--prompt-len`` tokens,
then ``--steps`` greedy decode steps.  It counts the PyTorch operations
one decode step dispatches (a ``TorchDispatchMode`` counter; the count is
the same on any device) and, on the card, profiles the prefill and the
decode steps with torch.profiler: wall s, the card's busy s and idle share,
kernel launches a step and the kernels that take the most device time.
One ``profile_serving {...}`` line, the profiler's tables in
``chiprun_out/profile_serving_<arch>_{prefill,decode}.txt``.  Prints the card's
name and power limit first; ``--device cuda`` without a card exits
non-zero.  It imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "tools"))

from chip_smoke import _sync, nvidia_smi  # noqa: E402
from profile_paths import device_times  # noqa: E402
from repro_torch.configs.registry import get_config, get_reduced  # noqa: E402
from repro_torch.core.cameo import _device  # noqa: E402
from repro_torch.models.model import (decode_step, model_defs,  # noqa: E402
                                      prefill)
from repro_torch.models.params import init_params  # noqa: E402

ARCH = "qwen3-0.6b"


class OpCounter(TorchDispatchMode):
    """Counts the operations dispatched below the autograd layer."""

    def __init__(self):
        super().__init__()
        self.ops = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops[str(func)] += 1
        return func(*args, **(kwargs or {}))


def _breakdown(prof, wall: float, steps: int, name: str) -> dict:
    """Busy s, idle share, launches a step and the top kernels of a
    profile; its table under chiprun_out/."""
    events, key, dev_us, dev_n = device_times(prof)
    busy = sum(dev_us.values()) / 1e6
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / f"profile_serving_{name}.txt").write_text(
        events.table(sort_by=key, row_limit=60))
    top = sorted(dev_us.items(), key=lambda kv: -kv[1])[:8]
    return dict(wall_s=wall, wall_ms_per_step=1e3 * wall / steps,
                device_busy_s=busy, busy_ms_per_step=1e3 * busy / steps,
                idle_share=1.0 - busy / wall if wall else None,
                launches_per_step=sum(dev_n.values()) / steps,
                top_kernels_us={k[:60]: v for k, v in top})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=ARCH)
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=2048)
    ap.add_argument("--steps", type=int, default=8)
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
    params = init_params(model_defs(cfg), 0, device, cfg.pdtype(),
                         draw="device" if device.type == "cuda" else "cpu")
    B, S, steps = args.batch, args.prompt_len, args.steps
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, size=(B, S))).long().to(device)

    def run_prefill():
        return prefill(params, cfg, {"tokens": tokens}, max_len=S + steps + 1)

    def run_decode(logits, caches, first: int):
        tok = torch.argmax(logits[:, -1, :], dim=-1)
        for i in range(steps):
            logits, caches = decode_step(params, cfg, tok[:, None], caches,
                                         first + i)
            tok = torch.argmax(logits[:, -1, :], dim=-1)
        return tok

    logits, caches = run_prefill()                        # warm
    counter = OpCounter()
    with counter:
        _, caches = decode_step(params, cfg, tokens[:, :1], caches, S)
    ops_step = sum(counter.ops.values())
    row = dict(arch=cfg.name, dtype=cfg.param_dtype, device=str(device),
               B=B, S=S, steps=steps, layers=cfg.n_layers,
               ops_per_decode_step=ops_step,
               ops_per_layer=ops_step / cfg.n_layers,
               top_ops=dict(counter.ops.most_common(8)))
    if device.type == "cuda":
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
        run_decode(logits, caches, S + 1)                  # warm
        _sync(device)
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            logits, caches = run_prefill()
            _sync(device)
            wall = time.perf_counter() - t0
        row["prefill"] = _breakdown(prof, wall, 1, f"{args.arch}_prefill")
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            run_decode(logits, caches, S)
            _sync(device)
            wall = time.perf_counter() - t0
        row["decode"] = _breakdown(prof, wall, steps, f"{args.arch}_decode")
    else:
        _sync(device)
        t0 = time.perf_counter()
        run_decode(logits, caches, S)
        row["decode_cpu_wall_ms_per_step"] = \
            1e3 * (time.perf_counter() - t0) / steps
    print("profile_serving " + json.dumps(row))
    return 0


if __name__ == "__main__":
    sys.exit(main())
